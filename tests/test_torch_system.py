"""End-to-end behaviour tests of the port: the paper's workflow at toy
scale, counterpart of tests/test_system.py with its sizes, step counts,
learning rates, seeds and thresholds.

The core claim (paper §5 + Table 2): a full-attention-pretrained model
fine-tuned briefly with SLA recovers its loss, and SLA beats the
linear-only ablation at the same budget. The pretrained fixture starts
from the reference's `dit.init(PRNGKey(0))`, carried over by
`repro_torch.bridge`, and trains on the port's `latent_batch` (bitwise
the reference's batches). Its untrained eval loss and first five
pretraining losses are held to the reference test's own `_eval_loss` /
`_train` at the bf16 limit, 5e-2 x max(1, |loss|) (both compute in bf16,
which rounds at other places in the two frameworks).
"""
import copy
import dataclasses

import jax
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
import test_system as jsys
from repro.models import dit as jdit
from repro_torch import bridge
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.config import SLAConfig
from repro_torch.data.pipeline import DataConfig, latent_batch
from repro_torch.models import dit
from repro_torch.optim import adamw

BF16_TOL = 5e-2  # tests/test_conformance.py's bf16 limit, x max(1, |loss|)


def _cfg(mode):
    return ArchConfig(
        name="dit-test", family="dit", num_layers=2, d_model=64,
        num_heads=2, num_kv_heads=2, head_dim=32, d_ff=128, vocab_size=0,
        patch_dim=8, cross_attn=False,
        attention_kind="full" if mode == "full" else "sla",
        sla=SLAConfig(block_q=16, block_kv=16, kh_frac=0.125,
                      kl_frac=0.25, mode="sla"))


def _batch(cfg, dc, step):
    shape = ShapeConfig("d", 128, 4, "train")
    return {k: torch.from_numpy(v).to(torch.float32)
            for k, v in latent_batch(cfg, shape, dc, step).items()}


def _train(cfg, params, steps, seed, sla_mode=None, lr=1e-3):
    opt_cfg = adamw.AdamWConfig(lr=lr, total_steps=steps, warmup_steps=2,
                                schedule="constant")
    named = dict(params.named_parameters())
    opt = adamw.init(named)
    dc = DataConfig(seed=seed)
    hist = []
    for s in range(steps):
        for p in named.values():
            p.grad = None
        loss = dit.loss_fn(params, cfg, _batch(cfg, dc, s),
                           sla_mode=sla_mode)
        loss.backward()
        # a parameter the loss does not read (sla_proj under full
        # attention) has a zero gradient, as the reference's
        grads = {n: torch.zeros_like(p) if p.grad is None else p.grad
                 for n, p in named.items()}
        adamw.update(named, grads, opt, opt_cfg)
        hist.append(float(loss.detach()))
    for p in named.values():
        p.grad = None
    return params, hist


@torch.no_grad()
def _eval_loss(cfg, params, sla_mode=None, batches=4, seed=10_000):
    """Held-out evaluation on FIXED batches (trailing train loss is too
    noisy for flow matching: every step draws new t ~ U)."""
    dc = DataConfig(seed=seed)
    total = 0.0
    for s in range(batches):
        total += float(dit.loss_fn(params, cfg, _batch(cfg, dc, s),
                                   sla_mode=sla_mode))
    return total / batches


def _close(got, want):
    return abs(got - want) <= BF16_TOL * max(1.0, abs(want))


@pytest.fixture(scope="module")
def pretrained():
    cfg, jcfg = _cfg("full"), jsys._cfg("full")
    jparams = jdit.init(jax.random.PRNGKey(0), jcfg)
    params = dit.init(None, cfg, device="cpu")
    params.load_state_dict(bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu"))
    init_eval = _eval_loss(cfg, params)
    ref_init_eval = jsys._eval_loss(jcfg, jparams)
    _, ref_hist = jsys._train(jcfg, jparams, 5, seed=0, lr=3e-3)
    params, hist = _train(cfg, params, 60, seed=0, lr=3e-3)
    return cfg, params, init_eval, dict(init_eval=ref_init_eval,
                                        hist=ref_hist, port_hist=hist[:5])


def test_pretraining_matches_the_reference_start(pretrained):
    _, _, init_eval, ref = pretrained
    assert _close(init_eval, ref["init_eval"]), (init_eval, ref)
    assert all(_close(g, w) for g, w in zip(ref["port_hist"], ref["hist"])
               ), ref


def test_pretraining_learns(pretrained):
    cfg, params, init_eval, _ = pretrained
    final_eval = _eval_loss(cfg, params)
    # rank-8 latents bound the learnable fraction at this tiny scale;
    # 60 steps @ 3e-3 lands ~13% below the untrained eval loss
    assert final_eval < init_eval * 0.92, (init_eval, final_eval)


def test_sla_finetune_recovers_loss(pretrained):
    """The paper's headline mechanism: swapping in SLA + a few fine-tune
    steps stays close to the full-attention loss."""
    cfg_full, params, _, _ = pretrained
    full_eval = _eval_loss(cfg_full, params)
    cfg = _cfg("sla")
    zero_shot = _eval_loss(cfg, params, sla_mode="sla")
    ft, _ = _train(cfg, copy.deepcopy(params), 40, seed=1, sla_mode="sla",
                   lr=5e-4)
    sla_eval = _eval_loss(cfg, ft, sla_mode="sla")
    assert sla_eval < full_eval * 1.5, (full_eval, sla_eval)
    # fine-tuning improved over the zero-shot swap
    assert sla_eval <= zero_shot + 1e-5, (zero_shot, sla_eval)


def test_sla_beats_linear_only_at_same_budget(pretrained):
    cfg_full, params, _, _ = pretrained
    cfg = _cfg("sla")
    sla_ft, _ = _train(cfg, copy.deepcopy(params), 30, seed=2,
                       sla_mode="sla", lr=5e-4)
    lin_ft, _ = _train(cfg, copy.deepcopy(params), 30, seed=2,
                       sla_mode="linear_only", lr=5e-4)
    sla_eval = _eval_loss(cfg, sla_ft, sla_mode="sla")
    lin_eval = _eval_loss(cfg, lin_ft, sla_mode="linear_only")
    assert sla_eval <= lin_eval * 1.05, (sla_eval, lin_eval)


def test_train_cli_end_to_end(tmp_path):
    """The launch/train.py CLI: run, checkpoint, resume."""
    from repro_torch.launch.train import main
    losses = main(["--arch", "qwen3-1.7b", "--smoke", "--steps", "6",
                   "--ckpt-dir", str(tmp_path), "--ckpt-every", "3",
                   "--log-every", "100", "--device", "cpu"])
    assert len(losses) == 6
    losses2 = main(["--arch", "qwen3-1.7b", "--smoke", "--steps", "8",
                    "--ckpt-dir", str(tmp_path), "--log-every", "100",
                    "--device", "cpu"])
    assert len(losses2) == 2  # resumed from step 6


def test_serving_engine_end_to_end():
    from repro_torch.configs import get_arch
    from repro_torch.models import registry
    from repro_torch.serving.engine import Request, ServingEngine

    cfg = get_arch("internvl2-1b").smoke()
    cfg = dataclasses.replace(cfg, family="dense", frontend="none",
                              num_patches=0)
    mdl = registry.get_model(cfg)
    params = mdl.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    rs = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rs.integers(
        0, cfg.vocab_size, size=32).astype(np.int32),
        max_new_tokens=4 + i % 3) for i in range(4)]
    engine = ServingEngine(cfg, params, batch_size=2, max_len=64)
    done = engine.run(reqs)
    assert all(len(r.tokens_out) == r.max_new_tokens for r in done)
    assert engine.stats.decode_tokens > 0
