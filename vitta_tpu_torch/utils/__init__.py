"""Host-side utilities of the port: meters and checkpoints."""
