"""Quickstart: SLA attention in 60 seconds, on the PyTorch/CUDA port.

Shows the three-way block classification, the FLOPs reduction at the
paper's operating point, agreement between the three execution paths
(dense reference / LUT gather / fused CUDA kernel), and gradients.

    PYTHONPATH=src:. python -m examples_torch.quickstart
    PYTHONPATH=src:. python -m examples_torch.quickstart --device cpu

On the CPU the kernel backend runs the kernels' plain PyTorch twins.
"""
import argparse

import torch

from repro_torch._device import resolve_device
from repro_torch.core import (SLAConfig, compute_mask, flops, plan_attention,
                              resolve, sla_attention, sla_init,
                              sparsity_stats)

B, H, N, D = 1, 4, 1024, 64
CFG = SLAConfig(block_q=64, block_kv=64, kh_frac=0.05, kl_frac=0.10,
                phi="softmax", causal=False)


def run(q, k, v, backend: str = "gather", params=None) -> dict:
    """Steps 1-4 on given (B, H, N, D) q, k, v; returns what was printed.
    `params` defaults to `sla_init`'s zero Proj."""
    backend = resolve(backend)  # unknown backend= fails loudly, up front
    cfg = CFG

    # 1. classification (Eq. 2-3)
    mc = compute_mask(q, k, cfg)
    stats = {kk: round(float(vv), 4)
             for kk, vv in sparsity_stats(mc).items()}
    print("block classification:", stats)

    # 2. FLOPs accounting at the paper's operating point (Table 1)
    acct = flops.sla_flops(32768, 128, 12, cfg)
    print(f"attention FLOPs at Wan2.1 shape: full={acct['full']:.3e} "
          f"sla={acct['total']:.3e} reduction={acct['reduction_x']:.1f}x")

    # 3. plan once, then all three execution backends agree on it
    if params is None:
        params = sla_init(q.shape[1], q.shape[-1], cfg, device=q.device)
    plan = plan_attention(q, k, cfg)
    with torch.no_grad():
        out_ref = sla_attention(params, q, k, v, cfg, backend="reference",
                                plan=plan)
        out_gather = sla_attention(params, q, k, v, cfg, backend="gather",
                                   plan=plan)
        out_kernel = sla_attention(params, q, k, v, cfg, backend="kernel",
                                   plan=plan)
    gather_err = float((out_gather - out_ref).abs().max())
    kernel_err = float((out_kernel - out_ref).abs().max())
    print("gather vs reference max|err|:", gather_err)
    print("kernel vs reference max|err|:", kernel_err)

    # 4. everything is differentiable (the paper's fine-tuning mode)
    p = {"proj": params["proj"].detach().clone().requires_grad_()}
    qg = q.detach().clone().requires_grad_()
    loss = torch.sum(sla_attention(p, qg, k, v, cfg, backend=backend) ** 2)
    gp, gq = torch.autograd.grad(loss, (p["proj"], qg))
    grad_proj, grad_q = float(torch.linalg.norm(gp)), float(
        torch.linalg.norm(gq))
    print("grad norms: proj", grad_proj, "dq", grad_q)
    return {"backend": backend, "stats": stats, "flops": acct,
            "ref_max_abs": float(out_ref.abs().max()),
            "gather_err": gather_err, "kernel_err": kernel_err,
            "grad_proj": grad_proj, "grad_q": grad_q}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", default="gather",
                    help="SLA execution backend (core.backends registry)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the "
                         "kernels' plain twins)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(0)
    q, k, v = (torch.randn((B, H, N, D), generator=gen, device=device,
                           dtype=torch.float32) for _ in range(3))
    return run(q, k, v, backend=args.backend)


if __name__ == "__main__":
    main()
