"""Model configurations of the port (dense decoder-only path)."""
