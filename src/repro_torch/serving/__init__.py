"""Serving surfaces of the port: the streaming DiT denoise service and the
static LM serving engine."""
