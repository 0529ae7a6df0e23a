"""Model API and serving of the port."""
