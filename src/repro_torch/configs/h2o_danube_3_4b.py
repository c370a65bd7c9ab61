"""h2o-danube-3-4b [dense]: llama+mistral mix with sliding-window attention.
[arXiv:2401.16818; unverified]"""
from repro_torch.configs.base import ArchConfig
from repro_torch.core.config import SLAConfig

CONFIG = ArchConfig(
    name="h2o-danube-3-4b", family="dense",
    num_layers=24, d_model=3840, num_heads=32, num_kv_heads=8,
    head_dim=120, d_ff=10240, vocab_size=32000,
    attention_kind="sla", sliding_window=8192,  # SWA composed into the SLA
    #                                              mask (block-granular)
    sla=SLAConfig(),
)
