"""Row-local classification and `plan_extend`, port against JAX.

The row half of `repro_torch.core.masks` (`row_valid`, `predict_pc_row`,
`predict_routing_row`, `score_row`, `classify_row`) is held to
`repro.core.masks` — score rows within 1e-6, classifications bitwise on
inputs with no near-ties — and `classify_row` to the port's own full
classifier row by row. `plan_extend` appended row by row from
`empty_plan` reproduces `plan_from_mask` (the reference's contract: mc,
lut, counts, col_counts, marginal and every live col_lut slot) and
equals the reference's `plan_extend` on the same rows.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from repro.core import masks as jmasks
from repro.core import plan as jplan
from repro.core.config import SLAConfig as JaxSLAConfig
from repro_torch.core import masks as tmasks
from repro_torch.core import plan as tplan
from repro_torch.core.config import SLAConfig

B, H, TN, D = 2, 3, 12, 16


def _cfgs(**kw):
    base = dict(block_q=16, block_kv=16, causal=True, kl_frac=0.0,
                col_capacity_factor=None, kh_frac=0.25)
    base.update(kw)
    return JaxSLAConfig(**base), SLAConfig(**base)


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0),
                                           (True, 40)])
def test_row_valid_and_classify_row_match_jax(causal, window):
    jcfg, tcfg = _cfgs(causal=causal, window=window)
    rs = np.random.default_rng(0)
    pc = rs.random((B, H, TN)).astype(np.float32)  # distinct: no ties
    for row in (0, 3, TN - 1):
        want_v = np.asarray(jmasks.row_valid(row, TN, jcfg))
        assert np.array_equal(tmasks.row_valid(row, TN, tcfg).numpy(),
                              want_v)
        want = np.asarray(jmasks.classify_row(jnp.asarray(pc), row, jcfg))
        got = tmasks.classify_row(torch.from_numpy(pc), row, tcfg)
        assert got.dtype == torch.int8
        assert np.array_equal(got.numpy(), want)
    rows = np.array([[2], [7]])  # per-slot rows, shaped (B, 1)
    want = np.asarray(jmasks.classify_row(jnp.asarray(pc),
                                          jnp.asarray(rows), jcfg))
    got = tmasks.classify_row(torch.from_numpy(pc), torch.from_numpy(rows),
                              tcfg)
    assert np.array_equal(got.numpy(), want)


def test_classify_row_is_the_full_classifier_row():
    _, tcfg = _cfgs()
    rs = np.random.default_rng(1)
    pc = torch.from_numpy(rs.random((B, H, TN, TN)).astype(np.float32))
    full = tmasks.classify_blocks(pc, tcfg)
    for row in range(TN):
        assert torch.equal(tmasks.classify_row(pc[..., row, :], row, tcfg),
                           full[..., row, :])
    with pytest.raises(ValueError, match="row-local"):
        tmasks.classify_row(pc[..., 0, :], 0,
                            SLAConfig(col_capacity_factor=2.0))


@pytest.mark.parametrize("routing_mode", ["threshold", "learned"])
def test_score_row_matches_jax(routing_mode):
    jcfg, tcfg = _cfgs(routing_mode=routing_mode)
    rs = np.random.default_rng(2)
    qpool = rs.standard_normal((B, H, D)).astype(np.float32)
    kpool = rs.standard_normal((B, H, TN, D)).astype(np.float32)
    routing = None
    if routing_mode == "learned":
        routing = {n: (np.eye(D, dtype=np.float32)
                       + 0.1 * rs.standard_normal((H, D, D)))
                   .astype(np.float32) for n in ("wq", "wk")}
    for row in (0, 5, TN - 1):
        want = np.asarray(jmasks.score_row(
            None if routing is None else
            {n: jnp.asarray(w) for n, w in routing.items()},
            jnp.asarray(qpool), jnp.asarray(kpool), row, jcfg))
        got = tmasks.score_row(
            None if routing is None else
            {n: torch.from_numpy(w) for n, w in routing.items()},
            torch.from_numpy(qpool), torch.from_numpy(kpool), row, tcfg)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)
        assert np.array_equal(
            tmasks.classify_row(got, row, tcfg).numpy(),
            np.asarray(jmasks.classify_row(jnp.asarray(want), row, jcfg)))
    with pytest.raises(ValueError, match="routing parameters"):
        tmasks.score_row(None, torch.from_numpy(qpool),
                         torch.from_numpy(kpool), 0,
                         SLAConfig(routing_mode="learned"))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("causal", [True, False])
def test_plan_extend_reproduces_plan_from_mask(seed, causal):
    jcfg, tcfg = _cfgs(causal=causal, fixed_budget=3)
    rs = np.random.default_rng(seed)
    pc = rs.random((B, H, TN, TN)).astype(np.float32)
    mc_t = tmasks.classify_blocks(torch.from_numpy(pc), tcfg)
    mc_j = jmasks.classify_blocks(jnp.asarray(pc), jcfg)
    assert np.array_equal(mc_t.numpy(), np.asarray(mc_j))
    full = tplan.plan_from_mask(mc_t, tcfg)
    plan = tplan.empty_plan(tcfg, B, H, TN, TN)
    jp = jplan.empty_plan(jcfg, B, H, TN, TN)
    for row in range(TN):
        same = tplan.plan_extend(plan, mc_t[..., row, :], row)
        assert same is plan  # appended in place
        jp = jplan.plan_extend(jp, mc_j[..., row, :], row)
    for name in ("mc", "lut", "counts", "col_counts", "marginal"):
        assert torch.equal(getattr(plan, name), getattr(full, name)), name
        assert np.array_equal(getattr(plan, name).numpy(),
                              np.asarray(getattr(jp, name))), name
    live = (torch.arange(plan.w_col) < plan.col_counts[..., None])
    assert torch.equal(plan.col_lut[live], full.col_lut[live])
    assert np.array_equal(plan.col_lut.numpy()[live.numpy()],
                          np.asarray(jp.col_lut)[live.numpy()])
