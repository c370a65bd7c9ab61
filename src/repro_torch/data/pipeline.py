"""Deterministic synthetic data pipeline.

Counterpart of `repro.data.pipeline` (numpy only, so each batch is
bitwise the reference's). Every batch is a pure function of
(seed, step, host_id): no state to checkpoint beyond the step counter,
and hosts never exchange data. Token streams are Markov chains
(x_{t+1} = (31 x_t + noise) mod V), so the LM loss has learnable
structure; DiT latents are low-rank Gaussian fields, so the
flow-matching loss has learnable structure.
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


def token_batch(cfg: ArchConfig, shape: ShapeConfig, dc: DataConfig,
                step: int) -> Dict[str, np.ndarray]:
    """Markov-chain tokens: x_{t+1} = (a * x_t + noise) mod V (learnable)."""
    rng = _batch_rng(dc, step)
    b = max(shape.global_batch // dc.num_hosts, 1)
    s = shape.seq_len
    v = cfg.vocab_size
    seq_dim = s
    if cfg.family == "vlm":
        seq_dim = s - cfg.num_patches
    x = np.empty((b, seq_dim + 1), np.int64)
    x[:, 0] = rng.integers(0, v, size=b)
    noise = rng.integers(0, 17, size=(b, seq_dim))
    for t in range(seq_dim):
        x[:, t + 1] = (x[:, t] * 31 + noise[:, t]) % v
    batch = {
        "tokens": x[:, :-1].astype(np.int32),
        "targets": x[:, 1:].astype(np.int32),
    }
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.standard_normal(
            (b, cfg.num_patches, cfg.d_model), np.float32)
    if cfg.family == "encdec":
        st = max(seq_dim // 8, 8)
        batch = {
            "audio_embeds": rng.standard_normal(
                (b, seq_dim, cfg.d_model), np.float32),
            "tokens": batch["tokens"][:, :st],
            "targets": batch["targets"][:, :st],
        }
    return batch


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
    dc = dc or DataConfig()
    step = start_step
    fn = latent_batch if cfg.family == "dit" else token_batch
    while True:
        yield fn(cfg, shape, dc, step)
        step += 1
