"""Serving surfaces of the port: the streaming DiT denoise service with
its cross-request plan cache, the static LM serving engine, and the
continuous LM scheduler with its paged, prefix-shared KV cache."""
