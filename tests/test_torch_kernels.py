"""The fused forward kernel's plain twin against the Pallas kernel.

`repro_torch.kernels.sla_fwd.sla_fwd_plain` is held to
`repro.kernels.sla_fwd.sla_fwd(interpret=True)` on the same numpy inputs:
f32 and bf16, bidirectional and causal with a `base` row offset, GQA
group 2, head dims 32 and 108. Tolerances are the conformance matrix's
(tests/test_conformance.py): f32 5e-5, bf16 5e-2.

The CUDA kernel itself runs only on a GPU: its tests are in
tests/test_torch_gpu.py, which imports no JAX so that it runs on the card.
"""
import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import plan as jplan
from repro.core.config import SLAConfig as JaxSLAConfig
from repro.kernels.sla_fwd import sla_fwd as jax_sla_fwd
from repro_torch.core.config import SLAConfig
from repro_torch.core.phi import phi
from repro_torch.core.plan import plan_attention
from repro_torch.kernels import _build, ops, ref, sla_fwd

TOL = {"f32": 5e-5, "bf16": 5e-2}
BLOCK = 16


def _case(seed, d, group, causal, base, dtype, h=4, n=128, span=4):
    """Numpy operands for one kernel call. Causal cases attend a span of
    `span` query blocks starting at block `base` against the full KV."""
    rs = np.random.default_rng(seed)
    hkv = h // group
    q = rs.standard_normal((h, n, d), dtype=np.float32)
    k = rs.standard_normal((hkv, n, d), dtype=np.float32)
    v = rs.standard_normal((hkv, n, d), dtype=np.float32)
    if dtype == "bf16":  # round once; both sides then see the same values
        q, k, v = (np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
                   for x in (q, k, v))
    cfg = JaxSLAConfig(block_q=BLOCK, block_kv=BLOCK, kh_frac=0.5,
                       kl_frac=0.25, causal=causal)
    plan = jplan.plan_attention(jnp.asarray(q[None]),
                                jnp.asarray(k[None]), cfg)
    lut, counts = np.asarray(plan.lut[0]), np.asarray(plan.counts[0])
    if causal:
        rows = slice(base, base + span)
        q, lut, counts = q[:, base * BLOCK:(base + span) * BLOCK], \
            lut[:, rows], counts[:, rows]
    else:
        base = 0
    tm = q.shape[1] // BLOCK
    qp = np.exp(q - q.max(-1, keepdims=True))
    qp = (qp / qp.sum(-1, keepdims=True)).astype(np.float32)
    hi = (0.1 * rs.standard_normal((h, tm, d, d))).astype(np.float32)
    zi = np.abs(rs.standard_normal((h, tm, d))).astype(np.float32)
    zi[0, 0] = 0.0  # an empty marginal set: o_l must be exactly 0 there
    return dict(lut=lut.astype(np.int32), counts=counts.astype(np.int32),
                q=q, k=k, v=v, qp=qp, hi=hi, zi=zi), base


def _torch_args(ops, dtype):
    t = {name: torch.from_numpy(np.array(a)) for name, a in ops.items()}
    if dtype == "bf16":
        for name in ("q", "k", "v"):
            t[name] = t[name].to(torch.bfloat16)
    return [t[n] for n in ("lut", "counts", "q", "k", "v", "qp", "hi", "zi")]


def _jax_args(ops, dtype):
    jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    return [jnp.asarray(ops["lut"]), jnp.asarray(ops["counts"]),
            *(jnp.asarray(ops[n], jd) for n in ("q", "k", "v")),
            jnp.asarray(ops["qp"]), jnp.asarray(ops["hi"]),
            jnp.asarray(ops["zi"])]


CASES = [
    pytest.param(d, group, causal, base, dtype,
                 id=f"d{d}-g{group}-{'causal' if causal else 'bidir'}"
                    f"{base}-{dtype}")
    for d in (32, 108)
    for group in (1, 2)
    for causal, base in ((False, 0), (True, 4))
    for dtype in ("f32", "bf16")
]


@pytest.mark.parametrize("d,group,causal,base,dtype", CASES)
def test_plain_twin_matches_pallas_kernel(d, group, causal, base, dtype):
    ops, base = _case(d + group, d, group, causal, base, dtype)
    kw = dict(scale=d ** -0.5, causal=causal, block_q=BLOCK,
              block_kv=BLOCK)
    want = jax_sla_fwd(*_jax_args(ops, dtype), **kw, interpret=True,
                       base=jnp.asarray([base], jnp.int32))
    launches = sla_fwd.LAUNCHES
    got = sla_fwd.sla_fwd(*_torch_args(ops, dtype), **kw, base=base)
    assert sla_fwd.LAUNCHES == launches  # CPU tensors: the plain twin
    for name, g, w in zip(("o_s", "o_l", "lse"), got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   atol=TOL[dtype], rtol=TOL[dtype],
                                   err_msg=name)
    assert torch.all(got[1][0, :BLOCK] == 0.0)  # den <= eps rows


@pytest.mark.parametrize("causal", [False, True])
def test_kernel_op_matches_dense_oracle(causal):
    """ops.sla_attention_core (h/z, aggregation, kernel twin) against the
    dense oracle of kernels/ref.py on the same plan."""
    cfg = SLAConfig(block_q=BLOCK, block_kv=BLOCK, kh_frac=0.25,
                    kl_frac=0.25, causal=causal)
    gen = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn((2, 2, 128, 32), generator=gen) for _ in range(3))
    plan = plan_attention(q, k, cfg)
    qp, kp = phi(q, cfg.phi), phi(k, cfg.phi)
    got = ops.sla_attention_core(q, k, v, qp, kp, plan, cfg)
    want = ref.sla_attention_core_reference(q, k, v, qp, kp, plan.mc, cfg)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=TOL["f32"], rtol=TOL["f32"])
    # a raw M_c works as the plan argument too
    again = ops.sla_attention_core(q, k, v, qp, kp, plan.mc, cfg)
    assert all(torch.equal(a, b) for a, b in zip(again, got))


def _valid_args(d=32):
    ops, _ = _case(0, d, 1, False, 0, "f32")
    return _torch_args(ops, "f32")


@pytest.mark.parametrize("change,match", [
    (lambda a: a.__setitem__(2, a[2].to(torch.float16)), "float32 or"),
    (lambda a: a.__setitem__(3, a[3].to(torch.bfloat16)), "share one"),
    (lambda a: a.__setitem__(5, a[5].to(torch.bfloat16)), "qp must"),
    (lambda a: a.__setitem__(0, a[0].long()), "lut must"),
    (lambda a: a.__setitem__(2, a[2].transpose(0, 1).contiguous()
                             .transpose(0, 1)), "contiguous"),
    (lambda a: a.__setitem__(0, a[0][:, :4]), "lut must be"),
])
def test_kernel_wrapper_checks_its_operands(change, match):
    args = _valid_args()
    change(args)
    with pytest.raises((TypeError, ValueError), match=match):
        sla_fwd._check(*args, BLOCK, BLOCK)


def test_kernel_wrapper_rejects_unsupported_head_dims_and_blocks():
    for d in (130, 30):
        with pytest.raises(ValueError, match="head dims"):
            sla_fwd._check(*_valid_args(d), BLOCK, BLOCK)
    with pytest.raises(ValueError, match="blocks of"):
        sla_fwd._check(*_valid_args(), 128, 128)
    sla_fwd._check(*_valid_args(108), BLOCK, BLOCK)  # 108 is taken


def test_kernel_wrapper_refuses_other_devices():
    args = [a.to("meta") for a in _valid_args()]
    with pytest.raises(ValueError, match="CUDA or CPU"):
        sla_fwd.sla_fwd(*args, scale=1.0, causal=False, block_q=BLOCK,
                        block_kv=BLOCK)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """A failed build raises; with no toolkit the error names nvcc."""
    if shutil.which("nvcc") or Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("this host has nvcc; the build itself is exercised by "
                    "tests/test_torch_gpu.py and chip_smoke.py")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build("sla_fwd")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()
    assert _build.kernel_names() == ["sla_bwd", "sla_bwd_tc", "sla_decode",
                                     "sla_fwd"]
