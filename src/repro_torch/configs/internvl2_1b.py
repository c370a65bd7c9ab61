"""internvl2-1b [vlm]: InternViT (stub) + qwen2-0.5b-style LM backbone.
[arXiv:2404.16821; hf]"""
from repro_torch.configs.base import ArchConfig
from repro_torch.core.config import SLAConfig

CONFIG = ArchConfig(
    name="internvl2-1b", family="vlm",
    num_layers=24, d_model=896, num_heads=14, num_kv_heads=2,
    head_dim=64, d_ff=4864, vocab_size=151655,
    frontend="vision_stub", num_patches=256,
    sla=SLAConfig(),
)
