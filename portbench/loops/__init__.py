"""The loops that drive a window, one file each, found by the name a
traffic file gives under ``loop`` (``harness/driver.py`` states what
each provides)."""
