"""Train, prefill and serve step builders, uniform across families (DiT,
dense, MoE and VLM LMs, the recurrent, hybrid and encoder-decoder LMs).
Counterpart of `repro.launch.steps`: `cast_params_bf16`,
`make_train_step`, `make_prefill_step`, `make_serve_step` and
`abstract_state`, the parameters and AdamW state on the `meta` device
that the dry run places over the production meshes.
"""
from __future__ import annotations

import types
from typing import Callable, Dict, Mapping, Optional, Tuple

import torch
import torch.nn as nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import registry
from repro_torch.optim import adamw


def cast_params_bf16(params: nn.Module):
    """One-shot f32 -> bf16 compute copy of the parameters, taken once
    before the forward (mixed precision: the f32 masters live only in the
    optimizer path). Returns the module's parameter tree with every f32
    tensor cast, as plain tensors that the model's `forward` reads like
    the module itself: attributes per module, a list for a ModuleList, a
    dict for a ParameterDict; submodules (an LM layer's `moe`, router
    included, as the reference casts every f32 leaf) recurse. The casts
    are differentiable, so gradients land on the f32 masters."""
    def cast(t):
        return t.to(torch.bfloat16) if t.dtype == torch.float32 else t

    if isinstance(params, nn.ModuleList):
        return [cast_params_bf16(m) for m in params]
    if isinstance(params, nn.ParameterDict):
        return {name: cast(p) for name, p in params.items()}
    tree = types.SimpleNamespace(**{
        name: cast(p) for name, p in params.named_parameters(recurse=False)})
    for name, child in params.named_children():
        setattr(tree, name, cast_params_bf16(child))
    return tree


def make_train_step(cfg: ArchConfig, opt_cfg: adamw.AdamWConfig,
                    backend: str = "gather", *, distill: bool = False,
                    trainable: Optional[Mapping[str, bool]] = None,
                    compute_bf16: bool = True,
                    compute_dtype: torch.dtype = torch.bfloat16,
                    guard: Optional[Callable] = None,
                    grad_transform: Optional[Callable] = None) -> Callable:
    """`train_step(params, opt_state, batch) -> (params, opt_state, loss,
    grad_norm)`: the model family's `loss_fn` on a bf16 compute copy of
    the f32 `params` (an nn.Module), its gradient on the masters, and one
    AdamW update of all parameters in place. `opt_state` comes from
    `adamw.init(dict(params.named_parameters()))`; `batch` is a dict of
    tensors on the parameters' device. Remat follows the caller's
    `distributed.ctx.activation_sharding` scope.

    The defaults are the reference's `make_train_step`. The training CLI
    sets the rest, as the reference's CLI loop does: `distill` takes the
    family's `distill_loss_fn` (a ValueError for a family without one:
    ssm, hybrid, encdec); `trainable` (name -> bool, from
    `adamw.trainable_mask`) updates only those parameters;
    `compute_bf16=False` runs the loss on the f32 parameters themselves
    (`compute_dtype` is the loss's activation dtype, bf16 by default as
    the reference's; f32 lets a test hold two runs to 5e-5); when
    `guard(loss)` is false the update is skipped and the step returns a
    grad norm of None; and `grad_transform(grads) -> grads`
    (name -> tensor dicts) runs after the guard and before the update,
    whose grad norm is then that of its output (the CLI's error-feedback
    compression).

    Over a mesh the parameters (and the moments) are DTensors placed by
    `distributed.sharding.place_module`, `batch` is the global batch, of
    which the model keeps this rank's rows, and the step runs under the
    caller's `activation_sharding(mesh, ...)`. The loss returned is the
    global one and `guard` sees it, so every rank skips together."""
    mdl = registry.get_model(cfg)
    loss_impl = mdl.loss_fn
    if distill:
        loss_impl = getattr(mdl, "distill_loss_fn", None)
        if loss_impl is None:
            raise ValueError(f"--distill: model family {cfg.family!r} has "
                             "no distill_loss_fn")

    def train_step(params, opt_state, batch):
        named = dict(params.named_parameters())
        for p in named.values():
            p.grad = None
        compute = cast_params_bf16(params) if compute_bf16 else params
        loss = loss_impl(compute, cfg, batch, compute_dtype=compute_dtype,
                         backend=backend)
        loss.backward()
        loss = loss.detach()
        gnorm = None
        if guard is None or guard(loss):
            # a parameter the loss does not read (a decoder block's
            # sla_proj) has a zero gradient, as the reference's
            grads = {n: torch.zeros_like(p) if p.grad is None else p.grad
                     for n, p in named.items()}
            if grad_transform is not None:
                grads = grad_transform(grads)
            _, opt_state, metrics = adamw.update(named, grads, opt_state,
                                                 opt_cfg,
                                                 trainable=trainable)
            gnorm = metrics["grad_norm"]
        for p in named.values():
            p.grad = None
        return params, opt_state, loss, gnorm

    return train_step


def make_prefill_step(cfg: ArchConfig, backend: str = "gather",
                      cache_len: Optional[int] = None) -> Callable:
    """`prefill_step(params, batch)`: the family's inference entry at a
    prefill shape (a DiT's is one denoising forward). Returns what the
    reference's does: (last hidden, cache) for the LMs, the velocity for
    a DiT. `cache_len` makes a dense, MoE, VLM or hybrid LM's KV caches
    that long (zero past the prompt) for the decode steps that follow.

    Under `activation_sharding(mesh, default_residual_spec(...))` the
    batch is the global one and the cache comes out as this rank's part
    under `sharding.cache_shardings` (the family's `prefill`)."""
    mdl = registry.get_model(cfg)
    if cache_len is not None and cfg.family not in ("dense", "moe", "vlm",
                                                    "hybrid"):
        raise ValueError(f"cache_len: the {cfg.family!r} family's prefill "
                         f"sizes its own caches")

    if cfg.family == "encdec":
        def prefill_step(params, batch):
            return mdl.prefill(params, cfg, batch, backend=backend)
    elif cfg.family == "dit":
        def prefill_step(params, batch):
            return mdl.forward(params, cfg, batch["latents"], batch["t"],
                               batch.get("cond"), backend=backend)
    else:
        sized = {} if cache_len is None else {"cache_len": cache_len}
        if cfg.family == "vlm":
            def prefill_step(params, batch):
                # pos counts the patch prefix: tokens + num_patches
                return mdl.prefill(params, cfg, batch["tokens"],
                                   backend=backend,
                                   prefix_embeds=batch["patch_embeds"],
                                   **sized)
        else:
            def prefill_step(params, batch):
                return mdl.prefill(params, cfg, batch["tokens"],
                                   backend=backend, **sized)

    return prefill_step


def make_serve_step(cfg: ArchConfig) -> Callable:
    """`serve_step(params, token, cache) -> (logits, cache)`: one decode
    step of the family's model (the cache is updated in place)."""
    mdl = registry.get_model(cfg)

    def serve_step(params, token, cache):
        return mdl.decode_step(params, cfg, token, cache)

    return serve_step


def abstract_state(cfg: ArchConfig) -> Tuple[Dict[str, torch.Tensor], dict]:
    """(params, opt_state) on the `meta` device: the parameters by name,
    shaped and typed as `init` makes them, and AdamW's moments and step,
    with no allocation and no generator draws."""
    mdl = registry.get_model(cfg)
    params = dict(mdl.init(None, cfg, device="meta").named_parameters())
    params = {n: p.detach() for n, p in params.items()}
    return params, adamw.init(params)
