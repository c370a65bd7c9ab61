"""Model registry: family -> module. Counterpart of
`repro.models.registry`, `get_model` half.

Every module exposes init(generator, cfg, device=), forward and loss_fn;
the DiT and LM ones (models/dit.py, models/transformer.py) add
distill_loss_fn. The LM module (the dense and MoE families) adds prefill,
decode_step and the serving caches that the continuous scheduler reaches
as `mdl.make_cache`, `mdl.insert_slot`, `mdl.make_paged_cache`,
`mdl.insert_slot_paged`, `mdl.insert_slot_state_paged`,
`mdl.slot_state_from_prefill` and `mdl.copy_page`, and chunked admission
as `mdl.check_chunked_prefill`, `mdl.make_prefill_carry`,
`mdl.prefill_chunk`, `mdl.finalize_chunked_prefill`, `mdl.carry_rows` and
`mdl.carry_restore`. The recurrent and encoder-decoder families
(models/rwkv6.py for "ssm", models/hybrid.py, models/encdec.py) add
prefill, decode_step and make_cache only, as in the reference. The VLM
family is the LM module with a prefix of patch embeddings.
"""
from __future__ import annotations

import importlib
import types

from repro_torch.configs.base import ArchConfig

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
