"""Config registry: --arch <id> resolution. Every arch of the JAX
registry is ported; an unknown name raises KeyError.
"""
from repro_torch.configs.base import (DIT_SHAPES, SHAPES, SMOKE_SHAPES,
                                      ArchConfig, ShapeConfig)

_ARCH_MODULES = {
    "wan2_1_1_3b": "wan2_1_1_3b",
    "lightningdit_1b": "lightningdit_1b",
    "qwen3-1.7b": "qwen3_1_7b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "zamba2-1.2b": "zamba2_1_2b",
    "rwkv6-7b": "rwkv6_7b",
    "whisper-small": "whisper_small",
    "h2o-danube-3-4b": "h2o_danube_3_4b",
    "gemma3-1b": "gemma3_1b",
    "mistral-large-123b": "mistral_large_123b",
    "internvl2-1b": "internvl2_1b",
}


# the 10 assigned archs (x 4 shapes) and the paper's own models
ASSIGNED_ARCHS = ["h2o-danube-3-4b", "gemma3-1b", "mistral-large-123b",
                  "qwen3-1.7b", "zamba2-1.2b", "rwkv6-7b", "whisper-small",
                  "moonshot-v1-16b-a3b", "llama4-maverick-400b-a17b",
                  "internvl2-1b"]
PAPER_ARCHS = ["wan2_1_1_3b", "lightningdit_1b"]


def get_arch(name: str) -> ArchConfig:
    import importlib
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}")
    mod = importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[name]}")
    return mod.CONFIG


def get_shape(name: str, smoke: bool = False) -> ShapeConfig:
    return (SMOKE_SHAPES if smoke else SHAPES)[name]


__all__ = ["ArchConfig", "ShapeConfig", "SHAPES", "SMOKE_SHAPES",
           "DIT_SHAPES", "ASSIGNED_ARCHS", "PAPER_ARCHS", "get_arch",
           "get_shape"]
