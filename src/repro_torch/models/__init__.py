"""Models of the port (dense transformer family)."""
