"""Model zoo of the port."""
