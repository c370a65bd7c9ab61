"""wan2.1-1.3b — the paper's video DiT (seq ~32K, bidirectional attention,
cross-attn to text cond). [arXiv:2503.20314]"""
from repro_torch.configs.base import ArchConfig
from repro_torch.core.config import SLAConfig

CONFIG = ArchConfig(
    name="wan2_1_1_3b", family="dit",
    num_layers=30, d_model=1536, num_heads=12, num_kv_heads=12,
    head_dim=128, d_ff=8960, vocab_size=0,
    patch_dim=64, cross_attn=True, cond_len=512,
    sla=SLAConfig(kh_frac=0.05, kl_frac=0.10, phi="softmax",
                  block_q=64, block_kv=64),
)
