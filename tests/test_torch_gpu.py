"""Tests of the port that need a CUDA device (marker `gpu`).

They skip inside the test body where `torch.cuda.is_available()` is
false, and import no JAX, so they run on a machine with the card:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_gpu.py

(`--noconftest` because tests/conftest.py imports JAX for the reference
tests.) The CUDA kernel is held to its plain twin on the same card
tensors, the kernel backend to the gather backend on a small DiT, and
the streaming service to the sequential sampler.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.core import plan as plan_lib
from repro_torch.core.config import SLAConfig
from repro_torch.core.phi import phi
from repro_torch.kernels import ops, sla_fwd
from repro_torch.models import dit

# Kernel and twin read the same (possibly bf16) inputs and accumulate in
# f32, so both dtypes are held to the f32 limit; 5e-2 is test_conformance's
# limit for the port's bf16 path against JAX's, not for kernel vs twin.
TWIN_TOL = 5e-5
pytestmark = pytest.mark.gpu


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _operands(seed, h, group, n, d, block, dtype, causal, base, span):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((1, h, n, d), generator=gen, device="cuda")
    k = torch.randn((1, h // group, n, d), generator=gen, device="cuda")
    v = torch.randn((1, h // group, n, d), generator=gen, device="cuda")
    cfg = SLAConfig(block_q=block, block_kv=block, kh_frac=0.25,
                    kl_frac=0.25, causal=causal)
    plan = plan_lib.plan_attention(q, k, cfg)
    q, k, v = (x.to(dtype) for x in (q, k, v))
    qp, kp = phi(q, cfg.phi), phi(k, cfg.phi)
    fk, fv, fkp = map(ops._flat, (k, v, kp))
    a = ops._flat(plan.marginal)
    hb, zb = ops._hz_blocks(fkp, fv, block)
    hb = torch.repeat_interleave(hb, group, dim=0)  # marginal is per q head
    zb = torch.repeat_interleave(zb, group, dim=0)
    hi, zi = ops._aggregate(a, hb, zb)
    lut, counts = ops._flat(plan.lut), ops._flat(plan.counts)
    fq, fqp = ops._flat(q), ops._flat(qp)
    if causal:  # a span of query blocks against the full KV
        rows = slice(base, base + span)
        cols = slice(base * block, (base + span) * block)
        lut, counts = lut[:, rows].contiguous(), counts[:, rows].contiguous()
        hi, zi = hi[:, rows].contiguous(), zi[:, rows].contiguous()
        fq, fqp = fq[:, cols].contiguous(), fqp[:, cols].contiguous()
    else:
        base = 0
    args = (lut, counts, fq, fk, fv, fqp, hi, zi)
    kw = dict(scale=d ** -0.5, causal=causal, block_q=block,
              block_kv=block, base=base)
    return args, kw


CASES = [
    # (h, group, n, d, block, causal, base)
    (4, 1, 256, 32, 16, False, 0),
    (4, 2, 256, 108, 16, True, 8),
    (2, 1, 512, 128, 64, False, 0),
    (2, 1, 512, 128, 64, True, 4),
    (3, 1, 384, 64, 32, False, 0),
    (2, 1, 256, 8, 16, True, 4),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("h,group,n,d,block,causal,base", CASES)
def test_cuda_kernel_matches_plain_twin(h, group, n, d, block, causal, base,
                                        dtype):
    _need_gpu()
    args, kw = _operands(7, h, group, n, d, block, dtype, causal, base,
                         span=4)
    before = sla_fwd.LAUNCHES
    got = sla_fwd.sla_fwd(*args, **kw)
    want = sla_fwd.sla_fwd_plain(*args, **kw)
    torch.cuda.synchronize()
    assert sla_fwd.LAUNCHES == before + 1
    for g, w in zip(got, want):
        assert g.is_cuda and g.dtype == torch.float32
        torch.testing.assert_close(g, w, atol=TWIN_TOL, rtol=TWIN_TOL)


def test_cuda_kernel_refuses_what_it_cannot_take():
    _need_gpu()
    args, kw = _operands(1, 2, 1, 256, 32, 16, torch.float32, False, 0, 4)
    bad = list(args)
    bad[2] = bad[2].half()
    with pytest.raises(TypeError, match="float32 or"):
        sla_fwd.sla_fwd(*bad, **kw)
    args, kw = _operands(1, 2, 1, 256, 132, 16, torch.float32, False, 0, 4)
    with pytest.raises(ValueError, match="head dims"):
        sla_fwd.sla_fwd(*args, **kw)


@pytest.mark.parametrize("arch", ["wan2_1_1_3b", "lightningdit_1b"])
def test_kernel_backend_matches_gather_on_a_small_dit(arch):
    """A smoke-size DiT forward on the card: kernel vs gather backend on
    the same plans, and the kernel ran once per layer."""
    _need_gpu()
    cfg = get_arch(arch).smoke()
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = dit.init(gen, cfg)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen,
                                      device="cuda"))
    rs = np.random.default_rng(0)
    lat = torch.from_numpy(rs.standard_normal(
        (2, 128, cfg.patch_dim), dtype=np.float32)).cuda()
    cond = (torch.from_numpy(rs.standard_normal(
        (2, cfg.cond_len, cfg.d_model), dtype=np.float32)).cuda()
        if cfg.cross_attn else None)
    t = torch.tensor([0.9, 0.3], device="cuda")
    with torch.no_grad():
        before = sla_fwd.LAUNCHES
        vk, plans = dit.forward(model, cfg, lat, t, cond, torch.float32,
                                "kernel", return_plans=True)
        assert sla_fwd.LAUNCHES == before + cfg.num_layers
        vg = dit.forward(model, cfg, lat, t, cond, torch.float32, "gather",
                         plans=plans)
    assert torch.isfinite(vk).all() and vk.abs().max() > 0.1
    torch.testing.assert_close(vk, vg, atol=1e-4, rtol=1e-4)


def test_scheduler_on_the_card_matches_sequential_sample():
    """The streaming service on the card (kernel backend, mixed
    timesteps, 2 slots) against each request's own batch-1 `sample`:
    cuBLAS may block a batch-2 GEMM differently from a batch-1 one, so
    the rows agree to f32 noise (1e-4), not bitwise."""
    _need_gpu()
    from repro_torch.serving.diffusion import (DenoiseParams,
                                               DiffusionScheduler)
    cfg = get_arch("wan2_1_1_3b").smoke()
    gen = torch.Generator(device="cuda").manual_seed(1)
    model = dit.init(gen, cfg)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen,
                                      device="cuda"))
    rs = np.random.default_rng(2)
    trace = [(3, 1.0), (2, 0.75), (2, 0.5)]
    reqs = [(s, t0, rs.standard_normal((128, cfg.patch_dim),
                                       dtype=np.float32),
             rs.standard_normal((cfg.cond_len, cfg.d_model),
                                dtype=np.float32)) for s, t0 in trace]
    sched = DiffusionScheduler(cfg, model, num_slots=2, seq_len=128,
                               backend="kernel", refresh_mode="fixed",
                               refresh_interval=2)
    for s, t0, lat, cond in reqs:
        sched.submit(lat, DenoiseParams(num_steps=s, t_start=t0), cond=cond)
    before = sla_fwd.LAUNCHES
    done = sched.drain()
    assert sla_fwd.LAUNCHES > before
    for r, (s, t0, lat, cond) in zip(done, reqs):
        ref = dit.sample(model, cfg, torch.from_numpy(lat[None]).cuda(),
                         num_steps=s,
                         cond=torch.from_numpy(cond[None]).cuda(),
                         compute_dtype=torch.float32, backend="kernel",
                         refresh_mode="fixed", refresh_interval=2,
                         t_start=t0)
        assert np.isfinite(r.result).all()
        np.testing.assert_allclose(r.result, ref[0].cpu().numpy(),
                                   atol=1e-4, rtol=1e-4)
