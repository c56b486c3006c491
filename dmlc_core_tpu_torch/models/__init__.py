"""Models of the port (single device)."""
