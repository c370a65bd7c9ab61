"""Serving surfaces of the port: the streaming DiT denoise service with
its cross-request plan cache, the static LM serving engine, the
continuous LM scheduler with its paged, prefix-shared KV cache, and
disaggregated prefill/decode serving (`disagg.py`: prefill and decode
worker pools with a handoff bundle and fault-injected requeue). Import
the modules themselves; the package pulls in none of them."""
