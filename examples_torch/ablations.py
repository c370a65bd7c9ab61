"""Ablations on a live toy model, on the PyTorch/CUDA port (paper Table 2
structure, mechanism-level): phi activation sweep and k_h sweep, measured
as attention-output fidelity against full attention on a *trained* DiT's
real Q/K/V (random weights give unstructured attention; trained maps are
what the paper classifies).

    PYTHONPATH=src:. python -m examples_torch.ablations
    PYTHONPATH=src:. python -m examples_torch.ablations --device cpu
"""
import argparse
import dataclasses

import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import SLAConfig, sla_attention, sla_init
from repro_torch.core.flops import sla_flops
from repro_torch.data.pipeline import DataConfig, latent_batch
from repro_torch.models import dit
from examples_torch.finetune_dit import build, to_device, train


def attention_fidelity(q, k, v, cfg):
    """Relative L2 error of SLA output vs full attention (proxy metric;
    proj is identity-initialized here so the linear branch contributes)."""
    params = sla_init(q.shape[1], q.shape[-1],
                      dataclasses.replace(cfg, proj_init="identity"),
                      device=q.device)
    full = sla_attention(None, q, k, v, cfg.replace(mode="full"))
    out = sla_attention(params, q, k, v, cfg)
    return float(torch.linalg.norm(out - full) / torch.linalg.norm(full))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--train-steps", type=int, default=30)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the "
                         "kernels' plain twins)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(0)

    # quickly train a small DiT so Q/K have realistic structure
    cfg_model = build("small", "full")
    cfg_model = dataclasses.replace(cfg_model, num_layers=4)
    shape = ShapeConfig("dit", args.seq, 8, "train")
    params = dit.init(gen, cfg_model, device=device)
    params, _ = train(cfg_model, params, shape, args.train_steps, 3e-4, 0,
                      log_every=1000)

    # pull real q, k, v from layer 0 on a fresh batch
    with torch.no_grad():
        batch = to_device(latent_batch(cfg_model, shape,
                                       DataConfig(seed=7), 0), device)
        x = batch["latents"] @ params.patch_in
        p0 = params.layers[0]
        b, n, d = x.shape
        h, dh = cfg_model.num_heads, cfg_model.head_dim
        q, k, v = ((x @ w).reshape(b, n, h, dh).transpose(1, 2)
                   for w in (p0.wq, p0.wk, p0.wv))
        return sweep(q, k, v, args.seq)


def sweep(q, k, v, seq: int) -> dict:
    """The three ablation tables on given q, k, v; returns their errors."""
    h, dh = q.shape[1], q.shape[-1]
    base = SLAConfig(block_q=32, block_kv=32, kh_frac=0.10, kl_frac=0.20)
    out = {"phi": {}, "kh": {}, "mode": {}}

    print("\n--- phi ablation (paper Table 2, activation rows) ---")
    for phi in ("softmax", "elu1", "relu"):
        err = attention_fidelity(q, k, v, base.replace(phi=phi))
        out["phi"][phi] = err
        print(f"  phi={phi:8s} rel-L2 error vs full: {err:.4f}")

    print("\n--- k_h ablation (paper Table 2, Top-k rows) ---")
    for kh in (0.05, 0.10, 0.20):
        cfg = base.replace(kh_frac=kh)
        err = attention_fidelity(q, k, v, cfg)
        fl = sla_flops(seq, dh, h, cfg)
        out["kh"][kh] = err
        print(f"  kh={kh:.2f} sparsity={fl['sparsity']:.0%} "
              f"reduction={fl['reduction_x']:5.1f}x rel-L2 {err:.4f}")

    print("\n--- mode comparison at kh=0.10 ---")
    for mode in ("sla", "sparse_only", "linear_only", "l_plus_s"):
        err = attention_fidelity(q, k, v, base.replace(mode=mode))
        out["mode"][mode] = err
        print(f"  {mode:12s} rel-L2 error vs full: {err:.4f}")
    return out


if __name__ == "__main__":
    main()
