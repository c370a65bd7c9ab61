"""The port's FLOPs accounting and public core surface against the
reference's.

- Every function of `repro_torch.core.flops` returns the reference's
  Python floats, equal with `==` (the same arithmetic in the same order),
  over sequence lengths, head dims and head counts, threshold and learned
  routing, a fixed decode budget and the decode variants' arguments.
- `repro_torch.core.__all__` covers `repro.core.__all__`, and every name
  resolves.
"""
import itertools

import pytest

from _torch_threads import one_torch_thread  # noqa: F401
import repro.core as jcore
from repro.core import flops as jflops
from repro.core.config import SLAConfig as JSLAConfig
import repro_torch.core as tcore
from repro_torch.core import flops as tflops
from repro_torch.core.config import SLAConfig

SIZES = list(itertools.product((1024, 32768), (64, 128), (4, 12)))
CFGS = {
    "threshold": dict(),
    "learned": dict(routing_mode="learned"),
    "wan": dict(block_q=64, block_kv=64, kh_frac=0.05, kl_frac=0.10),
    "budget": dict(decode_budget=7),
    "learned-budget": dict(routing_mode="learned", decode_budget=3,
                           block_q=32, block_kv=32),
}


def _cfgs(name):
    return JSLAConfig(**CFGS[name]), SLAConfig(**CFGS[name])


def _same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for key in a:
            assert type(a[key]) is type(b[key]), key
            assert a[key] == b[key], (key, a[key], b[key])
    else:
        assert type(a) is type(b)
        assert a == b, (a, b)


@pytest.mark.parametrize("n,d,h", SIZES)
def test_dense_counts_equal(n, d, h):
    for fn in ("full_attention_flops", "linear_attention_flops",
               "dense_decode_flops"):
        _same(getattr(jflops, fn)(n, d, h), getattr(tflops, fn)(n, d, h))


@pytest.mark.parametrize("name", sorted(CFGS))
@pytest.mark.parametrize("n,d,h", SIZES)
def test_sla_counts_equal(n, d, h, name):
    jcfg, tcfg = _cfgs(name)
    for overheads in (True, False):
        _same(jflops.sla_flops(n, d, h, jcfg, include_overheads=overheads),
              tflops.sla_flops(n, d, h, tcfg, include_overheads=overheads))
    _same(jflops.sla_subtractive_agg_flops(n, d, h, jcfg),
          tflops.sla_subtractive_agg_flops(n, d, h, tcfg))
    for k_sel in (None, 1, 5, 10_000):
        _same(jflops.sla_decode_flops(n, d, h, jcfg, num_critical=k_sel),
              tflops.sla_decode_flops(n, d, h, tcfg, num_critical=k_sel))


def test_core_surface_covers_the_reference():
    assert set(jcore.__all__) <= set(tcore.__all__), \
        sorted(set(jcore.__all__) - set(tcore.__all__))
    for name in tcore.__all__:
        assert getattr(tcore, name) is not None, name
    assert tcore.flops is tflops
    assert tcore.reference.__name__ == "repro_torch.core.reference"
    assert "refresh_plan_per_sample" in tcore.__all__
    assert tcore.PHI_KINDS == jcore.PHI_KINDS
