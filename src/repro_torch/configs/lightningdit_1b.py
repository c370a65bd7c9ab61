"""lightningdit-1b — the paper's image DiT (ImageNet 512x512 -> seq 1024).
[Yao et al., 2025]"""
from repro_torch.configs.base import ArchConfig
from repro_torch.core.config import SLAConfig

CONFIG = ArchConfig(
    name="lightningdit_1b", family="dit",
    num_layers=28, d_model=1728, num_heads=16, num_kv_heads=16,
    head_dim=108, d_ff=6912, vocab_size=0,
    patch_dim=32, cross_attn=False,
    sla=SLAConfig(kh_frac=0.125, kl_frac=0.25, block_q=64, block_kv=64),
)
