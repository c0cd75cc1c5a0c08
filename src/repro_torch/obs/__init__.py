"""Observability: the metrics registry (``metrics.py``)."""
