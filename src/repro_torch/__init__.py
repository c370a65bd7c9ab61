"""SLA (Sparse-Linear Attention) in PyTorch with hand-written CUDA kernels.

The PyTorch/CUDA counterpart of the JAX package `repro`, module for
module: `repro_torch.X` mirrors `repro.X`. It imports `torch` and never
JAX or `repro`; the tests hold each module against its JAX counterpart
on the same numpy inputs.

Entry points (`models.dit.init`, `serving.diffusion.DiffusionScheduler`,
`launch.serve`) run on the CUDA device unless the caller passes
`device="cpu"`; with no GPU and no explicit device they raise.
"""
from repro_torch._device import resolve_device

__all__ = ["resolve_device"]
