"""The multi-loss DCGAN trainer — counterpart of ``examples/dcgan``."""
