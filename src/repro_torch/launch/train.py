"""Training CLI of the port: DiT, dense and MoE LM, recurrent (rwkv6),
hybrid (zamba2) and encoder-decoder (whisper) families.

    python -m repro_torch.launch.train --arch wan2_1_1_3b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
        --smoke --steps 3 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-1.2b \
        --smoke --steps 2 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch lightningdit_1b \
        --smoke --distill --routing-mode learned --train-only routing,sla_proj \
        --routing-warm-init --steps 3 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
        --smoke --steps 4 --ckpt-dir /tmp/ckpt --ckpt-every 2 \
        --compress-grads --device cpu
    torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch qwen3-1.7b --smoke --steps 3 --data-mesh 2 --model-mesh 2
    OMP_NUM_THREADS=1 PYTHONPATH=src torchrun --standalone \
        --nproc-per-node 4 -m repro_torch.launch.train \
        --arch moonshot-v1-16b-a3b --smoke --steps 3 --device cpu \
        --data-mesh 2 --model-mesh 2

Counterpart of `repro.launch.train`: config -> seeded params ->
deterministic batches (latents for a DiT, Markov-chain tokens for an LM,
stub audio frames and text tokens for whisper) -> the family's loss (flow
matching or next-token cross-entropy, or with `--distill` its
distillation loss, which the ssm, hybrid and encdec families lack: a
ValueError, as the reference) and gradient under per-layer remat ->
AdamW (optionally on a `--train-only` subset) ->
straggler watchdog + NaN guard -> optional error-feedback gradient
compression (`--compress-grads`, between the guard and the update; its
error is carried across steps and not checkpointed) -> atomic async
checkpoints every `--ckpt-every` steps and at the end (`--ckpt-dir`),
from whose latest step a run resumes, its batches started at that step.
The loss keeps the reference's default backend ("gather"). `--device`
(default cuda) chooses the device; 'cpu' runs the kernels' plain twins.
The weights are random, from a seeded `torch.Generator` (not bitwise the
reference's init); the batches are bitwise the reference's.

Under torch.distributed (WORLD_SIZE set, as torchrun sets it, or a
process group already initialized) the CLI trains over a
`--data-mesh` x `--model-mesh` DeviceMesh (their product must be the
world size): parameters and AdamW state placed under the sharding rules,
a resume restored onto this mesh (`restore(shardings=)`), every step
under `activation_sharding(mesh, default_residual_spec(...),
remat=True)`. Every rank draws the same global batch and the model keeps
its rows; the loss and the NaN guard's decision are global, so every
rank skips together; rank 0 alone prints and writes checkpoints.
`--compress-grads` compresses the full gradient on every rank (gathered
from the shards, blocks as on one device) and keeps its error whole, so
its codes are those of a one-device run on the same gradient. Every
family runs sharded, at every world size, one included; a "model" axis
that does not divide what the family splits over it raises
(`sharding.check_mesh_family`). Without WORLD_SIZE, the CLI trains on
one device.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time
import warnings

import torch
import torch.distributed as dist

from repro_torch._device import resolve_device
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_arch, get_shape
from repro_torch.data.pipeline import DataConfig, make_iterator
from repro_torch.distributed import ctx as actx
from repro_torch.distributed import sharding
from repro_torch.distributed.fault_tolerance import NaNGuard, \
    StragglerWatchdog
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.steps import make_train_step
from repro_torch.models import registry
from repro_torch.optim import adamw
from repro_torch.optim.compression import ef_compress_decompress, ef_init

ROUTING_WARM_EPS = 1e-3


@torch.no_grad()
def routing_warm_init(params):
    """Replace every layer's zero-initialized per-head Proj merge
    (`sla_proj`) with an epsilon-scaled identity (`ROUTING_WARM_EPS * I`),
    in place.

    Opt-in escape hatch for the learned-routing dead point (see
    `check_routing_dead_point`): a tiny but nonzero Proj lets the
    straight-through routing gradients through from step 0 while
    perturbing the model's output by only O(eps * ||o_l||)."""
    for layer in params.layers:
        proj = layer.sla_proj
        eye = torch.eye(proj.shape[-1], dtype=proj.dtype,
                        device=proj.device)
        proj.copy_(torch.broadcast_to(eye, proj.shape) * ROUTING_WARM_EPS)
    return params


def check_routing_dead_point(params, mask) -> bool:
    """Warn loudly when a fine-tune is pinned at the learned-routing
    dead point: the routing head is trainable but every `sla_proj` is
    exactly zero. Routing parameters only receive gradients through the
    straight-through marginal gates of the LINEAR branch, and that
    branch's output is multiplied by `sla_proj` (Eq. 6), so all-zero
    Proj multiplies every routing gradient by exact zero and
    `--train-only routing` silently flatlines. `params` and `mask` are
    name -> tensor / bool dicts. Returns True iff the warning fired."""
    trains_routing = any("routing" in name and t for name, t in mask.items())
    proj = [p for name, p in params.items() if name.endswith("sla_proj")]
    if not trains_routing or not proj:
        return False
    if any(bool(torch.any(p != 0)) for p in proj):
        return False
    warnings.warn(
        "learned-routing dead point: --train-only includes the routing "
        "head, but every sla_proj is exactly zero (the paper's init). "
        "Routing gradients flow only through the linear branch, whose "
        "output is multiplied by sla_proj — they are therefore all "
        "exactly zero and routing will never move. Pass "
        "--routing-warm-init to seed sla_proj with an epsilon identity, "
        "or include 'sla_proj' in --train-only and train the merge off "
        "zero first.")
    return True


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config + shape (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--data-mesh", type=int, default=1)
    ap.add_argument("--model-mesh", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda; 'cpu' "
                         "runs the kernels' plain twins)")
    ap.add_argument("--distill", action="store_true",
                    help="fine-tune against the model family's end-to-end "
                         "distillation loss (exact-attention teacher, SLA "
                         "student; paper Sec. 5) instead of the training "
                         "loss")
    ap.add_argument("--routing-mode", default=None,
                    choices=["threshold", "learned"],
                    help="override SLAConfig.routing_mode: 'learned' adds "
                         "the trainable SLA2-style routing head "
                         "(identity-initialized to reproduce 'threshold' "
                         "exactly)")
    ap.add_argument("--train-only", default=None,
                    help="comma-separated parameter-name substrings to "
                         "train (e.g. 'routing,sla_proj'); everything "
                         "else is frozen — the fixed-FLOP-budget "
                         "fine-tuning recipe")
    ap.add_argument("--routing-warm-init", action="store_true",
                    help="seed every layer's sla_proj with a small "
                         "epsilon-scaled identity (1e-3) instead of the "
                         "paper's zero init, which pins '--train-only "
                         "routing' at exactly zero routing gradients")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    if args.routing_mode is not None:
        cfg = dataclasses.replace(
            cfg, sla=cfg.sla.replace(routing_mode=args.routing_mode))
    shape = get_shape(args.shape, smoke=args.smoke)
    mdl = registry.get_model(cfg)
    opt_cfg = adamw.AdamWConfig(lr=args.lr, total_steps=args.steps,
                                warmup_steps=max(args.steps // 10, 1))
    mesh = _mesh(args, cfg)
    rank0 = mesh is None or dist.get_rank() == 0
    say = print if rank0 else (lambda *a, **k: None)
    device = resolve_device(args.device)

    gen = torch.Generator(device=device).manual_seed(args.seed)
    model = mdl.init(gen, cfg, device=device)
    if args.routing_warm_init:
        routing_warm_init(model)
    shardings = None
    if mesh is not None:
        p_shard = sharding.place_module(model, mesh)
        shardings = {"params": p_shard,
                     "opt": sharding.opt_shardings(p_shard)}
    params = dict(model.named_parameters())
    opt_state = adamw.init(params)

    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start_step = 0
    if mgr is not None and mgr.latest_step() is not None:
        start_step = mgr.latest_step()
        state = mgr.restore(start_step, {"params": params, "opt": opt_state},
                            shardings=shardings)
        with torch.no_grad():
            for name, p in params.items():
                p.copy_(state["params"][name])
        opt_state = state["opt"]
        say(f"resumed from step {start_step}")

    data = make_iterator(cfg, shape, DataConfig(seed=args.seed),
                         start_step=start_step)
    grad_transform = None
    if args.compress_grads:
        ef_error = ef_init({n: sharding.full(p) for n, p in params.items()})

        def grad_transform(grads):
            nonlocal ef_error
            full = {n: sharding.full(g) for n, g in grads.items()}
            full, ef_error, _ = ef_compress_decompress(full, ef_error)
            if mesh is None:
                return full
            return {n: sharding.place(g, p_shard[n]) for n, g in full.items()}

    mask = None
    if args.train_only:
        mask = adamw.trainable_mask(
            params, tuple(s for s in args.train_only.split(",") if s))
        n_train = sum(p.numel() for n, p in params.items() if mask[n])
        if n_train == 0:
            raise ValueError(
                f"--train-only {args.train_only!r} matches no parameters")
        say(f"training {n_train} of "
            f"{sum(p.numel() for p in params.values())} params "
            f"({args.train_only})")
        check_routing_dead_point(
            {n: sharding.full(p).detach() for n, p in params.items()}, mask)

    watchdog = StragglerWatchdog()
    guard = NaNGuard()
    # The reference's CLI loop: the loss's default backend on the f32
    # parameters (no bf16 compute copy), the NaN guard, then compression,
    # before the update.
    train_step = make_train_step(cfg, opt_cfg, distill=args.distill,
                                 trainable=mask, compute_bf16=False,
                                 guard=_global_guard(guard, mesh),
                                 grad_transform=grad_transform)
    residual = (None if mesh is None else actx.default_residual_spec(
        mesh, shape.global_batch, shape.seq_len))
    losses = []
    with actx.activation_sharding(mesh, residual, remat=True):
        for step in range(start_step, args.steps):
            t0 = time.time()
            batch = {k: torch.from_numpy(v).to(device)
                     for k, v in next(data).items()}
            model, opt_state, loss, gnorm = train_step(model, opt_state,
                                                       batch)
            if gnorm is None:
                say(f"step {step}: non-finite loss, update skipped")
                continue
            loss = float(loss)
            dt = time.time() - t0
            slow = watchdog.record(dt)
            losses.append(loss)
            if step % args.log_every == 0 or step == args.steps - 1:
                extra = " STRAGGLER" if slow else ""
                lr = adamw.schedule_lr(opt_cfg, opt_state["step"])
                say(f"step {step:5d} loss {loss:.4f} "
                    f"gnorm {float(gnorm):.3f} "
                    f"lr {float(lr):.2e} {dt:.2f}s{extra}", flush=True)
            if mgr is not None and (step + 1) % args.ckpt_every == 0:
                mgr.save(step + 1, {"params": params, "opt": opt_state})
        if mgr is not None:
            mgr.save(args.steps, {"params": params, "opt": opt_state},
                     blocking=True)
    if watchdog.flagged:
        say(f"stragglers flagged: {len(watchdog.flagged)}")
    if losses:  # a run resumed at --steps takes no step
        say(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")
    return losses


def _mesh(args, cfg):
    """The run's DeviceMesh under torch.distributed, else None (one
    device)."""
    if not (dist.is_initialized() or "WORLD_SIZE" in os.environ):
        if args.data_mesh * args.model_mesh > 1:
            raise ValueError(
                f"--data-mesh {args.data_mesh} --model-mesh "
                f"{args.model_mesh} needs torch.distributed: launch "
                f"data x model ranks with torchrun")
        return None
    dev = mesh_lib.init_distributed(args.device)
    mesh = mesh_lib.make_host_mesh(args.data_mesh, args.model_mesh, dev)
    sharding.check_mesh_family(cfg, mesh)
    return mesh


def _global_guard(guard: NaNGuard, mesh):
    """The NaN guard's check; over a mesh, on the loss of any rank being
    non-finite (the loss is global, but one split decision would
    deadlock the next collective)."""
    if mesh is None:
        return guard.check

    def check(loss):
        bad = (~torch.isfinite(loss)).to(torch.float32).reshape(1)
        dist.all_reduce(bad, op=dist.ReduceOp.MAX)
        return guard.check(torch.where(bad > 0, float("nan"), loss))

    return check


if __name__ == "__main__":
    main()
