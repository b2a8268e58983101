"""The async open-loop serving driver (``driver.py``)."""
