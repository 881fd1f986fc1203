"""Device ops of the port."""
