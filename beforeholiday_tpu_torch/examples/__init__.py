"""Example trainers — counterparts of the repository's ``examples/``."""
