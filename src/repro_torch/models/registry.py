"""Model registry: family -> module. Counterpart of
`repro.models.registry`, `get_model` half.

Every module exposes init(generator, cfg, device=), forward, loss_fn and
distill_loss_fn; the LM module (models/transformer.py, the dense and MoE
families) adds prefill, decode_step and the serving caches that the
continuous scheduler reaches as `mdl.make_cache`, `mdl.insert_slot`,
`mdl.make_paged_cache`, `mdl.insert_slot_paged`,
`mdl.insert_slot_state_paged`, `mdl.slot_state_from_prefill` and
`mdl.copy_page`, and chunked admission as `mdl.check_chunked_prefill`,
`mdl.make_prefill_carry`, `mdl.prefill_chunk`,
`mdl.finalize_chunked_prefill`, `mdl.carry_rows` and
`mdl.carry_restore`. The DiT, dense and MoE families are
ported; the others raise and name the ROADMAP.md queue-1 item that ports
them.
"""
from __future__ import annotations

import types

from repro_torch.configs.base import ArchConfig

# family -> the ROADMAP.md queue-1 item that ports it
_NOT_YET_PORTED = {"vlm": 15, "ssm": 15, "hybrid": 15, "encdec": 15}


def get_model(cfg: ArchConfig) -> types.ModuleType:
    if cfg.family == "dit":
        from repro_torch.models import dit
        return dit
    if cfg.family in ("dense", "moe"):
        from repro_torch.models import transformer
        return transformer
    if cfg.family in _NOT_YET_PORTED:
        raise NotImplementedError(
            f"model family {cfg.family!r} is not ported to repro_torch yet "
            f"(ROADMAP.md queue 1, item {_NOT_YET_PORTED[cfg.family]})")
    raise KeyError(f"unknown model family {cfg.family!r}")
