"""Hand-written CUDA kernels for Hopper, each beside its plain twin.

Kernels build at first use (`_build.py`); importing this package needs
neither nvcc nor a GPU.
"""
