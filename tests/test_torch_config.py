"""The port's config copies equal the JAX package's (repro_torch.core.config,
repro_torch.configs) — fields, defaults, derived budgets, validate()
failures, smoke() reductions, and the arch registry."""
import dataclasses

import pytest

from _torch_threads import one_torch_thread  # noqa: F401
from repro.configs import get_arch as jax_get_arch
from repro.core.config import SLAConfig as JaxSLAConfig
from repro_torch.configs import get_arch
from repro_torch.core.config import SLAConfig

PORTED_ARCHS = ("wan2_1_1_3b", "lightningdit_1b", "qwen3-1.7b",
                "moonshot-v1-16b-a3b", "llama4-maverick-400b-a17b",
                "zamba2-1.2b", "rwkv6-7b", "whisper-small",
                "h2o-danube-3-4b", "gemma3-1b", "mistral-large-123b",
                "internvl2-1b")


def _fields(cls):
    return [(f.name, f.default) for f in dataclasses.fields(cls)]


def test_sla_config_fields_and_defaults_equal():
    assert _fields(SLAConfig) == _fields(JaxSLAConfig)
    assert SLAConfig().PHIS == JaxSLAConfig().PHIS
    for name in ("MODES", "ROUTING_MODES", "PLAN_REFRESH_MODES",
                 "DECODE_MODES"):
        assert getattr(SLAConfig, name) == getattr(JaxSLAConfig, name)


@pytest.mark.parametrize("tn", [1, 2, 3, 5, 10, 16, 30, 50, 512])
@pytest.mark.parametrize("kh,kl", [(0.05, 0.10), (0.25, 0.25),
                                   (0.125, 0.25), (0.5, 0.0)])
def test_budgets_equal_including_bankers_rounding(tn, kh, kl):
    a = SLAConfig(kh_frac=kh, kl_frac=kl)
    b = JaxSLAConfig(kh_frac=kh, kl_frac=kl)
    assert a.num_critical(tn) == b.num_critical(tn)
    assert a.num_negligible(tn) == b.num_negligible(tn)
    assert a.col_capacity(tn, tn) == b.col_capacity(tn, tn)
    assert a.col_capacity(2 * tn, tn) == b.col_capacity(2 * tn, tn)


def test_num_critical_keeps_round_half_to_even():
    # 0.25 * 2 = 0.5 and 0.05 * 50 = 2.5 round to even: 0 -> max(1, 0), 2
    assert SLAConfig(kh_frac=0.25).num_critical(2) == 1
    assert SLAConfig(kh_frac=0.05).num_critical(50) == 2
    assert SLAConfig(fixed_budget=7).num_critical(4) == 4


BAD_KNOBS = [
    dict(mode="sparse"), dict(phi="tanh"), dict(routing_mode="random"),
    dict(plan_refresh_mode="sometimes"), dict(decode_mode="fast"),
    dict(block_q=0), dict(kh_frac=1.5), dict(kl_frac=-0.1),
    dict(plan_refresh_interval=0), dict(window=-1),
    dict(window=64, decode_mode="sla"),
    dict(decode_mode="sla", block_q=32, block_kv=64),
    dict(page_pool_size=1), dict(paged=True, block_q=32, block_kv=64),
    dict(prefill_chunk_blocks=0),
]


@pytest.mark.parametrize("knobs", BAD_KNOBS,
                         ids=[",".join(k) for k in BAD_KNOBS])
def test_validate_rejects_the_same_knobs(knobs):
    with pytest.raises(ValueError) as want:
        JaxSLAConfig(**knobs).validate()
    with pytest.raises(ValueError) as got:
        SLAConfig(**knobs).validate()
    assert str(got.value) == str(want.value)


def test_drift_thresholds_and_decode_plan_cfg_equal():
    for thr in (0.1, (0.0, 0.5, 1.0)):
        a = SLAConfig(plan_drift_threshold=thr)
        b = JaxSLAConfig(plan_drift_threshold=thr)
        assert a.drift_thresholds(3) == b.drift_thresholds(3)
    with pytest.raises(ValueError, match="entries"):
        SLAConfig(plan_drift_threshold=(0.1, 0.2)).drift_thresholds(3)
    a = dataclasses.asdict(SLAConfig().decode_plan_cfg(40))
    b = dataclasses.asdict(JaxSLAConfig().decode_plan_cfg(40))
    assert a == b


@pytest.mark.parametrize("arch", PORTED_ARCHS)
@pytest.mark.parametrize("smoke", [False, True])
def test_dit_arch_configs_equal(arch, smoke):
    a, b = get_arch(arch), jax_get_arch(arch)
    if smoke:
        a, b = a.smoke(), b.smoke()
    da, db = dataclasses.asdict(a), dataclasses.asdict(b)
    assert da == db


def test_every_reference_arch_resolves():
    """Every arch of the JAX registry resolves through `get_arch` and
    `registry.get_model` (the VLM family to the transformer module); an
    unknown name raises KeyError."""
    from repro.configs import ASSIGNED_ARCHS, PAPER_ARCHS
    from repro_torch.models import registry, transformer
    assert sorted(ASSIGNED_ARCHS + PAPER_ARCHS) == sorted(PORTED_ARCHS)
    for arch in PORTED_ARCHS:
        assert registry.get_model(get_arch(arch)) is not None
    assert get_arch("internvl2-1b").family == "vlm"
    assert registry.get_model(get_arch("internvl2-1b")) is transformer
    with pytest.raises(KeyError):
        get_arch("no-such-arch")


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "rwkv6-7b",
                                  "whisper-small"])
def test_new_families_resolve_to_their_modules(arch):
    from repro_torch.models import encdec, hybrid, registry, rwkv6
    want = {"hybrid": hybrid, "ssm": rwkv6, "encdec": encdec}
    cfg = get_arch(arch)
    assert registry.get_model(cfg) is want[cfg.family]
