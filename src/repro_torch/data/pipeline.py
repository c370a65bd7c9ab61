"""Deterministic synthetic data pipeline, DiT half.

Counterpart of `repro.data.pipeline` (numpy only, so each batch is
bitwise the reference's). Every batch is a pure function of
(seed, step, host_id): no state to checkpoint beyond the step counter,
and hosts never exchange data. DiT latents are low-rank Gaussian fields,
so the flow-matching loss has learnable structure. `token_batch` arrives
with the LM slice (ROADMAP.md queue 1, item 13).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.configs.base import ArchConfig, ShapeConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    num_hosts: int = 1
    host_id: int = 0


def _batch_rng(dc: DataConfig, step: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([dc.seed, step, dc.host_id]))


def latent_batch(cfg: ArchConfig, shape: ShapeConfig, dc: DataConfig,
                 step: int, rank: int = 8) -> Dict[str, np.ndarray]:
    """DiT batch: low-rank latent 'videos' + noise + uniform t."""
    rng = _batch_rng(dc, step)
    b = max(shape.global_batch // dc.num_hosts, 1)
    n, p = shape.seq_len, cfg.patch_dim
    u = rng.standard_normal((b, n, rank)).astype(np.float32)
    w = rng.standard_normal((rank, p)).astype(np.float32)
    batch = {
        "latents": (u @ w) / np.sqrt(rank),
        "noise": rng.standard_normal((b, n, p)).astype(np.float32),
        "t": rng.uniform(0.02, 0.98, size=(b,)).astype(np.float32),
    }
    if cfg.cross_attn:
        batch["cond"] = rng.standard_normal(
            (b, cfg.cond_len or 64, cfg.d_model)).astype(np.float32)
    return batch


def make_iterator(cfg: ArchConfig, shape: ShapeConfig,
                  dc: Optional[DataConfig] = None,
                  start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    if cfg.family != "dit":
        raise NotImplementedError(
            f"token batches for family {cfg.family!r} are not ported to "
            "repro_torch yet (ROADMAP.md queue 1, item 13)")
    dc = dc or DataConfig()
    step = start_step
    while True:
        yield latent_batch(cfg, shape, dc, step)
        step += 1
