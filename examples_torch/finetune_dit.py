"""End-to-end workflow on the PyTorch/CUDA port: pretrain a DiT with full
attention, then fine-tune with SLA (the paper's §5 workflow) and compare
against the Table-2 ablation baselines (sparse-only / linear-only / L+S)
at equal budget.

Defaults are CPU-runnable (~5M params, `--device cpu`); --preset 100m
gives the ~100M configuration for the card.

    PYTHONPATH=src:. python -m examples_torch.finetune_dit \
        --pretrain-steps 150 --finetune-steps 150

Only the `sla` mode reaches an execution backend (`--backend kernel`
runs the fused CUDA kernels); the other modes run the dense reference
paths of `core/reference.py`.
"""
import argparse
import copy
import time

import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.config import SLAConfig
from repro_torch.data.pipeline import DataConfig, latent_batch
from repro_torch.models import dit
from repro_torch.optim import adamw

PRESETS = {
    # ~5M — CPU-runnable demo
    "small": dict(num_layers=6, d_model=256, num_heads=4, head_dim=64,
                  d_ff=1024, seq=512, batch=4),
    # ~100M — the end-to-end scale from the deliverable (real hardware)
    "100m": dict(num_layers=12, d_model=768, num_heads=12, head_dim=64,
                 d_ff=3072, seq=4096, batch=32),
}


def build(preset: str, mode: str) -> ArchConfig:
    p = PRESETS[preset]
    return ArchConfig(
        name=f"dit-{preset}", family="dit",
        num_layers=p["num_layers"], d_model=p["d_model"],
        num_heads=p["num_heads"], num_kv_heads=p["num_heads"],
        head_dim=p["head_dim"], d_ff=p["d_ff"], vocab_size=0,
        patch_dim=16, cross_attn=False,
        attention_kind="full" if mode == "full" else "sla",
        sla=SLAConfig(block_q=32, block_kv=32, kh_frac=0.10, kl_frac=0.20,
                      phi="softmax", mode=mode if mode != "full" else "sla"),
    )


def to_device(batch: dict, device) -> dict:
    """A numpy batch as f32 tensors on `device` (the latents arrive in
    f64 from numpy's promotion; the reference's `jnp.asarray` makes them
    f32 too)."""
    return {k: torch.from_numpy(v).to(device, torch.float32)
            for k, v in batch.items()}


def train(cfg, params, shape, steps, lr, seed, sla_mode=None, log_every=25,
          backend="gather", on_step=None):
    """AdamW on the flow-matching loss (bf16 compute over the f32
    parameters), in place on `params` (a `dit.DiT`), on its device.
    `on_step(step, loss)` runs after each update. Returns (params, the
    losses)."""
    opt_cfg = adamw.AdamWConfig(lr=lr, total_steps=steps,
                                warmup_steps=max(steps // 10, 1),
                                schedule="cosine")
    named = dict(params.named_parameters())
    opt = adamw.init(named)
    device = next(iter(named.values())).device

    def step_fn(batch):
        for p in named.values():
            p.grad = None
        loss = dit.loss_fn(params, cfg, batch, backend=backend,
                           sla_mode=sla_mode)
        loss.backward()
        grads = {n: torch.zeros_like(p) if p.grad is None else p.grad
                 for n, p in named.items()}
        adamw.update(named, grads, opt, opt_cfg)
        for p in named.values():
            p.grad = None
        return loss.detach()

    dc = DataConfig(seed=seed)
    hist = []
    for s in range(steps):
        batch = to_device(latent_batch(cfg, shape, dc, s), device)
        loss = step_fn(batch)
        hist.append(float(loss))
        if on_step is not None:
            on_step(s, hist[-1])
        if s % log_every == 0 or s == steps - 1:
            print(f"    step {s:4d} loss {hist[-1]:.5f}", flush=True)
    return params, hist


def report(results: dict) -> bool:
    """Print the quality table; returns whether SLA is best among the
    accelerated modes (the paper's Table 2 ordering)."""
    print("\n=== fine-tune quality (flow-matching loss; lower=better, "
          "full attention is the reference) ===")
    for k, v in sorted(results.items(), key=lambda kv: kv[1]):
        gap = v - results["full_attention"]
        print(f"  {k:16s} {v:.5f}  (gap {gap:+.5f})")
    order_ok = results.get("sla", 9e9) <= min(
        results.get("sparse_only", 9e9), results.get("linear_only", 9e9),
        results.get("l_plus_s", 9e9))
    print(f"\nSLA best among accelerated modes: {order_ok} "
          "(paper Table 2 ordering)")
    return order_ok


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="small", choices=list(PRESETS))
    ap.add_argument("--pretrain-steps", type=int, default=150)
    ap.add_argument("--finetune-steps", type=int, default=150)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--modes", default="sla,sparse_only,linear_only,l_plus_s")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--backend", default="gather",
                    help="SLA execution backend of the sla mode: 'gather' "
                         "(default), 'reference' or 'kernel'")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the "
                         "kernels' plain twins)")
    args = ap.parse_args(argv)

    p = PRESETS[args.preset]
    shape = ShapeConfig("dit", p["seq"], p["batch"], "train")
    device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(args.seed)

    # ---- phase A: "pretrain" with full attention
    cfg_full = build(args.preset, "full")
    params = dit.init(gen, cfg_full, device=device)
    n = sum(x.numel() for x in params.parameters())
    print(f"[pretrain] {n/1e6:.1f}M params, full attention, "
          f"{args.pretrain_steps} steps")
    t0 = time.time()
    params, hist = train(cfg_full, params, shape, args.pretrain_steps,
                         args.lr, args.seed, backend=args.backend)
    full_loss = sum(hist[-10:]) / len(hist[-10:])
    print(f"[pretrain] done in {time.time()-t0:.0f}s, "
          f"loss {full_loss:.5f}")

    # ---- phase B: fine-tune with each attention mode (paper §5 + Table 2)
    results = {"full_attention": full_loss}
    for mode in args.modes.split(","):
        cfg = build(args.preset, mode)
        print(f"[finetune:{mode}] {args.finetune_steps} steps")
        ft_params, hist = train(
            cfg, copy.deepcopy(params), shape, args.finetune_steps,
            args.lr * 0.5, args.seed + 1, sla_mode=mode,
            backend=args.backend)
        first = sum(hist[:5]) / 5
        final = sum(hist[-10:]) / len(hist[-10:])
        results[mode] = final
        print(f"[finetune:{mode}] first-5 {first:.5f} -> "
              f"final {final:.5f}")
        del ft_params
    report(results)
    return results


if __name__ == "__main__":
    main()
