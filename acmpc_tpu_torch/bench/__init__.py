"""On-card measurement scripts of the port."""
