"""Training utilities of the port: the lossy wire formats."""
