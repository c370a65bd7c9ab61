"""Serving surfaces of the port (the streaming DiT denoise service so far)."""
