"""Model registry: family -> module, plus per-(arch x shape) input specs.
Counterpart of `repro.models.registry`.

Every module exposes init(generator, cfg, device=), forward and loss_fn;
the DiT and LM ones (models/dit.py, models/transformer.py) add
distill_loss_fn. The LM module (the dense and MoE families) adds prefill,
decode_step and the serving caches that the continuous scheduler reaches
as `mdl.make_cache`, `mdl.insert_slot`, `mdl.make_paged_cache`,
`mdl.insert_slot_paged`, `mdl.insert_slot_state_paged`,
`mdl.slot_state_from_prefill`, `mdl.set_page_table` and `mdl.copy_page`,
and chunked admission
as `mdl.check_chunked_prefill`, `mdl.make_prefill_carry`,
`mdl.prefill_chunk`, `mdl.finalize_chunked_prefill`, `mdl.carry_rows` and
`mdl.carry_restore`. The recurrent and encoder-decoder families
(models/rwkv6.py for "ssm", models/hybrid.py, models/encdec.py) add
prefill, decode_step and make_cache only, as in the reference. The VLM
family is the LM module with a prefix of patch embeddings.

`train_batch_specs`, `prefill_specs` and `decode_specs` give the inputs
of an (arch x shape) cell as tensors on the `meta` device (shape and
dtype, no allocation), which the dry run places under the sharding
rules; `make_concrete_batch` draws a batch like them from a
`torch.Generator` (not the reference's `jax.random` values).
"""
from __future__ import annotations

import importlib
import types
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig

_FAMILY = {
    "dit": "dit",
    "dense": "transformer",
    "moe": "transformer",
    "vlm": "transformer",
    "ssm": "rwkv6",
    "hybrid": "hybrid",
    "encdec": "encdec",
}


def get_model(cfg: ArchConfig) -> types.ModuleType:
    if cfg.family in _FAMILY:
        return importlib.import_module(
            f"repro_torch.models.{_FAMILY[cfg.family]}")
    raise KeyError(f"unknown model family {cfg.family!r}")


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_batch_specs(cfg: ArchConfig, shape: ShapeConfig
                      ) -> Dict[str, Optional[torch.Tensor]]:
    b, s = shape.global_batch, shape.seq_len
    f32, i32 = torch.float32, torch.int32
    if cfg.family == "dit":
        return {
            "latents": _spec((b, s, cfg.patch_dim), f32),
            "noise": _spec((b, s, cfg.patch_dim), f32),
            "t": _spec((b,), f32),
            "cond": _spec((b, cfg.cond_len or 64, cfg.d_model), f32)
            if cfg.cross_attn else None,
        }
    if cfg.family == "encdec":
        st = max(s // 8, 8)
        return {
            "audio_embeds": _spec((b, s, cfg.d_model), f32),
            "tokens": _spec((b, st), i32),
            "targets": _spec((b, st), i32),
        }
    batch = {"tokens": _spec((b, s), i32), "targets": _spec((b, s), i32)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = _spec((b, cfg.num_patches, cfg.d_model),
                                      f32)
        batch["tokens"] = _spec((b, s - cfg.num_patches), i32)
        batch["targets"] = _spec((b, s - cfg.num_patches), i32)
    return batch


def decode_specs(cfg: ArchConfig, shape: ShapeConfig):
    """(token, cache) specs for the serve step at this shape: the
    family's `make_cache` on the meta device."""
    b, s = shape.global_batch, shape.seq_len
    cache = get_model(cfg).make_cache(cfg, b, s, dtype=torch.bfloat16,
                                      device="meta")
    return _spec((b,), torch.int32), cache


def prefill_specs(cfg: ArchConfig, shape: ShapeConfig
                  ) -> Dict[str, Optional[torch.Tensor]]:
    b, s = shape.global_batch, shape.seq_len
    f32, i32 = torch.float32, torch.int32
    if cfg.family == "encdec":
        return {"audio_embeds": _spec((b, s, cfg.d_model), f32)}
    if cfg.family == "vlm":
        return {"tokens": _spec((b, s - cfg.num_patches), i32),
                "patch_embeds": _spec((b, cfg.num_patches, cfg.d_model),
                                      f32)}
    if cfg.family == "dit":
        # DiT "prefill" = one full denoising forward (its inference step)
        return {"latents": _spec((b, s, cfg.patch_dim), f32),
                "t": _spec((b,), f32),
                "cond": _spec((b, cfg.cond_len or 64, cfg.d_model), f32)
                if cfg.cross_attn else None}
    return {"tokens": _spec((b, s), i32)}


def make_concrete_batch(generator: torch.Generator, cfg: ArchConfig,
                        shape: ShapeConfig, device=None) -> Dict[str, Any]:
    """A random batch matching `train_batch_specs`, drawn from
    `generator` (on `device`): integers uniform in [0, vocab - 1), floats
    standard normal, the diffusion time `t` uniform in [0, 1)."""
    out = {}
    for key, sp in train_batch_specs(cfg, shape).items():
        if sp is None:
            continue
        if sp.dtype == torch.int32:
            out[key] = torch.randint(0, max(cfg.vocab_size - 1, 2),
                                     tuple(sp.shape), generator=generator,
                                     dtype=torch.int32, device=device)
        elif key == "t":
            out[key] = torch.rand(tuple(sp.shape), generator=generator,
                                  device=device)
        else:
            out[key] = torch.randn(tuple(sp.shape), generator=generator,
                                   device=device)
    return out
