"""Architecture configuration schema + the assigned input shapes."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.core.config import SLAConfig


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm | dit
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # attention pattern
    attention_kind: str = "sla"  # per-layer default: sla | full | swa
    sliding_window: int = 0  # swa window (0 = unused)
    local_global_pattern: int = 0  # gemma3: every Nth layer is global
    local_window: int = 1024
    qk_norm: bool = False
    rope_theta: float = 1e4

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    moe_shared_expert: bool = False

    # SSM / hybrid
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 0
    attn_every: int = 0  # zamba2: shared attn block every N ssm layers
    conv_kernel: int = 4

    # enc-dec
    encoder_layers: int = 0
    decoder_layers: int = 0

    # frontends (stubs per assignment)
    frontend: str = "none"  # none | audio_stub | vision_stub
    num_patches: int = 0  # vlm prefix length

    # DiT
    patch_dim: int = 0  # latent channel dim for DiT io
    cross_attn: bool = False
    cond_len: int = 0

    sla: SLAConfig = SLAConfig()
    tie_embeddings: bool = True

    # reduced config factory for smoke tests
    def smoke(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        changes = dict(
            num_layers=min(self.num_layers, 2),
            d_model=128,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2) or 0,
            head_dim=32,
            d_ff=256,
            vocab_size=512,
            sla=dataclasses.replace(self.sla, block_q=16, block_kv=16,
                                    kh_frac=0.25, kl_frac=0.25),
        )
        if self.num_experts:
            changes.update(num_experts=4, experts_per_token=min(
                2, self.experts_per_token), moe_d_ff=64)
        if self.ssm_state:
            changes.update(ssm_state=16, ssm_heads=4, ssm_head_dim=32)
        if self.attn_every:
            changes.update(num_layers=4, attn_every=2)
        if self.encoder_layers:
            changes.update(encoder_layers=2, decoder_layers=2)
        if self.local_global_pattern:
            changes.update(num_layers=4, local_global_pattern=2,
                           local_window=32)
        if self.num_patches:
            changes.update(num_patches=16)
        if self.sliding_window:
            changes.update(sliding_window=64)
        if self.patch_dim:
            changes.update(patch_dim=16, cond_len=16)
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

# Paper-arch extra cells (beyond the assigned 40): the paper's own models.
DIT_SHAPES = {
    "wan2_1_1_3b": ShapeConfig("dit_video_32k", 32768, 16, "train"),
    "lightningdit_1b": ShapeConfig("dit_image_1k", 1024, 256, "train"),
}

# Reduced shapes for CPU smoke tests (same kinds).
SMOKE_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 128, 2, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 256, 1, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 256, 2, "decode"),
    "long_500k": ShapeConfig("long_500k", 512, 1, "decode"),
}
