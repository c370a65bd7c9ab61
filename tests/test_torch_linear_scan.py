"""The port's chunked decayed linear attention (`repro_torch.models.
linear_scan`) against the reference's `repro.models.linear_scan`.

Same numpy inputs from a seed on both sides; f32 within 5e-5 x max(1,
max |ref|), the bf16 per-channel path within 5e-2 x max(1, max |ref|).

- `decayed_la_chunked` in both conventions (Mamba's inclusive scalar
  decay, RWKV's exclusive per-channel decay with and without the `u`
  bonus) and the other two combinations, at chunks that divide N, one
  that the rule cuts (N 50 at chunk 16 runs chunks of 10) and N 17 at
  chunk 64 (one chunk of 17); with and without an `s0` carry; also with
  the per-channel pair tensors built a group of chunks at a time.
- `decayed_la_scan` and `decayed_la_step` in both conventions.
- The bf16 per-channel path rounds its (C, C) matrix and v to bf16 before
  the AV product, and the scalar path does not: both against the
  reference in bf16, and the rounding shown to matter.
- Gradients of q, k, v, logw, u and s0 through the chunked form.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from repro.models import linear_scan as jls
from repro_torch.models import linear_scan as tls

TOL = 5e-5
BF16_TOL = 5e-2
B, H, DK, DV = 2, 3, 8, 6


def _close(got, want, name, tol=TOL):
    want = np.asarray(want, dtype=np.float32)
    got = np.asarray(got, dtype=np.float32)
    atol = tol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=atol, rtol=0, err_msg=name)


def _inputs(n, scalar_decay, seed=0, with_u=False, with_s0=False):
    rs = np.random.default_rng(seed)
    f = lambda *s: rs.standard_normal(s).astype(np.float32)
    q, k, v = f(B, H, n, DK), f(B, H, n, DK), f(B, H, n, DV)
    if scalar_decay:
        logw = -np.log1p(np.exp(f(B, H, n))).astype(np.float32)
    else:
        logw = -np.exp(np.clip(f(B, H, n, DK) - 1.0, -8.0, 5.0))
    out = dict(q=q, k=k, v=v, logw=logw.astype(np.float32))
    out["u"] = (0.5 * f(H, DK)) if with_u else None
    out["s0"] = f(B, H, DK, DV) if with_s0 else None
    return out


def _jax(fn, ins, **kw):
    args = {k: (None if a is None else jnp.asarray(a))
            for k, a in ins.items()}
    o, s = fn(args.pop("q"), args.pop("k"), args.pop("v"),
              args.pop("logw"), u=args.pop("u"), s0=args.pop("s0"), **kw)
    return np.asarray(o), np.asarray(s)


def _torch(fn, ins, dtype=torch.float32, **kw):
    t = {k: (None if a is None else torch.from_numpy(a))
         for k, a in ins.items()}
    q, k, v = (t[n].to(dtype) for n in ("q", "k", "v"))
    o, s = fn(q, k, v, t["logw"], u=t["u"], s0=t["s0"], **kw)
    return o.detach().numpy(), s.detach().numpy()


CONVENTIONS = [  # (inclusive, scalar_decay, u)
    pytest.param(True, True, False, id="mamba-inclusive-scalar"),
    pytest.param(False, False, True, id="rwkv-exclusive-vector-u"),
    pytest.param(False, False, False, id="exclusive-vector"),
    pytest.param(True, False, False, id="inclusive-vector"),
    pytest.param(False, True, False, id="exclusive-scalar"),
]
CHUNKS = [(48, 16), (50, 16), (17, 64), (64, 64)]


@pytest.mark.parametrize("n,chunk", CHUNKS,
                         ids=[f"n{n}-c{c}" for n, c in CHUNKS])
@pytest.mark.parametrize("inclusive,scalar,with_u", CONVENTIONS)
def test_chunked_matches_jax(inclusive, scalar, with_u, n, chunk):
    ins = _inputs(n, scalar, seed=n + chunk, with_u=with_u,
                  with_s0=n == 50)
    kw = dict(inclusive=inclusive, chunk=chunk, scalar_decay=scalar)
    jo, js = _jax(jls.decayed_la_chunked, ins, **kw)
    to, ts = _torch(tls.decayed_la_chunked, ins, **kw)
    _close(to, jo, "o")
    _close(ts, js, "state")


def test_chunk_rule_is_the_reference_rule():
    assert tls.chunk_size(17, 64) == 17
    assert tls.chunk_size(50, 16) == 10
    assert tls.chunk_size(4096, 64) == 64
    assert tls.chunk_size(97, 64) == 1


def test_pair_tensor_groups_match_one_group(monkeypatch):
    """Per-channel pair tensors built 1 or 2 chunks at a time give the
    same result as all chunks at once."""
    ins = _inputs(48, False, seed=3, with_u=True, with_s0=True)
    kw = dict(inclusive=False, chunk=8, scalar_decay=False)
    whole = _torch(tls.decayed_la_chunked, ins, **kw)
    per_chunk = B * H * 8 * 8 * DK
    for elems in (per_chunk, 2 * per_chunk + 1):
        monkeypatch.setattr(tls, "PAIR_ELEMS", elems)
        got = _torch(tls.decayed_la_chunked, ins, **kw)
        for a, b in zip(got, whole):
            np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)


@pytest.mark.parametrize("inclusive,scalar,with_u", CONVENTIONS[:2])
def test_scan_and_step_match_jax(inclusive, scalar, with_u):
    ins = _inputs(9, False, seed=5, with_u=with_u, with_s0=True)
    jo, js = _jax(jls.decayed_la_scan, ins, inclusive=inclusive)
    to, ts = _torch(tls.decayed_la_scan, ins, inclusive=inclusive)
    _close(to, jo, "scan o")
    _close(ts, js, "scan state")
    # one step from the carried state, and the chunked form against the
    # scan: the oracle relation the reference tests
    one = {k: (a[:, :, 0] if k in ("q", "k", "v", "logw") else a)
           for k, a in ins.items()}
    u = None if one["u"] is None else jnp.asarray(one["u"])
    jo1, js1 = jls.decayed_la_step(
        *(jnp.asarray(one[k]) for k in ("q", "k", "v", "logw")),
        jnp.asarray(one["s0"]), u=u, inclusive=inclusive)
    to1, ts1 = tls.decayed_la_step(
        *(torch.from_numpy(one[k]) for k in ("q", "k", "v", "logw")),
        torch.from_numpy(one["s0"]),
        u=None if u is None else torch.from_numpy(one["u"]),
        inclusive=inclusive)
    _close(to1.numpy(), jo1, "step o")
    _close(ts1.numpy(), js1, "step state")
    co, cs = _torch(tls.decayed_la_chunked, ins, inclusive=inclusive,
                    chunk=4)
    _close(co, to, "chunked vs scan o", tol=1e-4)
    _close(cs, ts, "chunked vs scan state", tol=1e-4)


@pytest.mark.parametrize("scalar", [False, True],
                         ids=["vector-rounds", "scalar-f32"])
def test_bf16_inputs_match_jax(scalar):
    """bf16 q, k, v: the per-channel path rounds its (C, C) matrix and v
    to bf16 before the AV product (the scalar path never rounds); both
    match the reference's bf16 run."""
    ins = _inputs(32, scalar, seed=7, with_u=not scalar)
    bf = {k: (None if a is None or k in ("logw", "u") else
              np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)))
          for k, a in ins.items()}
    ins16 = {k: (bf[k] if bf[k] is not None else a)
             for k, a in ins.items()}
    kw = dict(inclusive=scalar, chunk=16, scalar_decay=scalar)
    jargs = {k: (None if a is None else (
        jnp.asarray(a, jnp.bfloat16) if k in ("q", "k", "v")
        else jnp.asarray(a))) for k, a in ins16.items()}
    jo, js = jls.decayed_la_chunked(jargs["q"], jargs["k"], jargs["v"],
                                    jargs["logw"], u=jargs["u"], **kw)
    to, ts = _torch(tls.decayed_la_chunked, ins16, dtype=torch.bfloat16,
                    **kw)
    _close(to, jo, "o", tol=BF16_TOL)
    _close(ts, js, "state", tol=BF16_TOL)
    # f32 inputs holding the same values: the vector path's rounding is
    # what separates the two; the scalar path is exactly the f32 run
    fo, _ = _torch(tls.decayed_la_chunked, ins16, **kw)
    if scalar:
        np.testing.assert_array_equal(to, fo)
    else:
        assert np.abs(to - fo).max() > 1e-4


GRAD_CASES = CONVENTIONS[:2]


@pytest.mark.parametrize("inclusive,scalar,with_u", GRAD_CASES)
def test_chunked_grads_match_jax(inclusive, scalar, with_u):
    ins = _inputs(24, scalar, seed=11, with_u=with_u, with_s0=True)
    names = [k for k, a in ins.items() if a is not None]
    rs = np.random.default_rng(12)
    wo = rs.standard_normal((B, H, 24, DV)).astype(np.float32)
    ws = rs.standard_normal((B, H, DK, DV)).astype(np.float32)
    kw = dict(inclusive=inclusive, chunk=8, scalar_decay=scalar)

    def jloss(*args):
        a = dict(zip(names, args))
        o, s = jls.decayed_la_chunked(a["q"], a["k"], a["v"], a["logw"],
                                      u=a.get("u"), s0=a["s0"], **kw)
        return jnp.sum(o * wo) + jnp.sum(s * ws)

    jg = jax.grad(jloss, argnums=tuple(range(len(names))))(
        *(jnp.asarray(ins[n]) for n in names))
    t = {n: torch.from_numpy(ins[n]).requires_grad_() for n in names}
    o, s = tls.decayed_la_chunked(t["q"], t["k"], t["v"], t["logw"],
                                  u=t.get("u"), s0=t["s0"], **kw)
    ((o * torch.from_numpy(wo)).sum()
     + (s * torch.from_numpy(ws)).sum()).backward()
    for n, g in zip(names, jg):
        _close(t[n].grad.numpy(), g, f"d{n}")
