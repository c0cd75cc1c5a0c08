"""Fault injection and elastic recovery (``faults.py``, ``elastic.py``)."""
