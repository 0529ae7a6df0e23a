"""Image models of the port."""
