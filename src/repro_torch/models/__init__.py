"""Model families of the port (the DiT so far)."""
