"""Sparse formats, planners, executors and the distributed api."""
