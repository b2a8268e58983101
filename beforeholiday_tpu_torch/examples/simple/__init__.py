"""Small single-file examples (counterparts of ``examples/simple``)."""
