"""qwen3-1.7b [dense]: qk-norm + GQA. [hf:Qwen/Qwen3-8B; hf]"""
from repro_torch.configs.base import ArchConfig
from repro_torch.core.config import SLAConfig

CONFIG = ArchConfig(
    name="qwen3-1.7b", family="dense",
    num_layers=28, d_model=2048, num_heads=16, num_kv_heads=8,
    head_dim=128, d_ff=6144, vocab_size=151936,
    qk_norm=True, rope_theta=1e6,
    sla=SLAConfig(),
)
