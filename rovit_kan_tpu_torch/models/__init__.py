"""Model modules of the port."""
