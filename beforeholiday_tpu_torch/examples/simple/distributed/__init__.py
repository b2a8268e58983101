"""Distributed examples (counterparts of ``examples/simple/distributed``)."""
