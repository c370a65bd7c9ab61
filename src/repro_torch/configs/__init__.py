"""Config registry: --arch <id> resolution.

Only the DiT configs are ported so far; asking for any other arch of the
JAX registry raises and names the ROADMAP item that ports its family.
"""
from repro_torch.configs.base import (ArchConfig, ShapeConfig, SHAPES,
                                      SMOKE_SHAPES)

_ARCH_MODULES = {
    "wan2_1_1_3b": "wan2_1_1_3b",
    "lightningdit_1b": "lightningdit_1b",
}

# arch -> the ROADMAP.md queue-1 item that ports its model family
_NOT_YET_PORTED = {
    "qwen3-1.7b": 13,
    "h2o-danube-3-4b": 15,
    "gemma3-1b": 15,
    "mistral-large-123b": 15,
    "zamba2-1.2b": 15,
    "rwkv6-7b": 15,
    "whisper-small": 15,
    "moonshot-v1-16b-a3b": 15,
    "llama4-maverick-400b-a17b": 15,
    "internvl2-1b": 15,
}


def get_arch(name: str) -> ArchConfig:
    import importlib
    if name in _NOT_YET_PORTED:
        raise NotImplementedError(
            f"arch {name!r} is not ported to repro_torch yet (ROADMAP.md "
            f"queue 1, item {_NOT_YET_PORTED[name]}); ported: "
            f"{sorted(_ARCH_MODULES)}")
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}")
    mod = importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[name]}")
    return mod.CONFIG


__all__ = ["ArchConfig", "ShapeConfig", "SHAPES", "SMOKE_SHAPES",
           "get_arch"]
