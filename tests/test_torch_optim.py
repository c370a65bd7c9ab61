"""The port's AdamW (repro_torch.optim.adamw) against the reference's.

Both run the same numpy parameters and gradients; the port keys leaves by
name and updates in place, the reference returns new pytrees keyed by the
same names. Parameters, moments, grad_norm and lr agree within 1e-6 over
3 steps with global-norm clipping and a trainable mask; `schedule_lr`
agrees within 1e-6 for every schedule.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from repro.optim import adamw as jadamw
from repro_torch.configs import get_arch
from repro_torch.models import dit
from repro_torch.optim import adamw

TOL = dict(atol=1e-6, rtol=1e-6)
SHAPES = {"patch_in": (6, 4), "layers.0.wq": (4, 5),
          "layers.0.sla_proj": (2, 3, 3), "layers.1.routing.wq": (2, 3, 3),
          "ln_f": (4,)}


@pytest.mark.parametrize("train_only", [None, ("routing", "sla_proj")],
                         ids=["all", "routing+sla_proj"])
def test_update_matches_jax_over_three_steps(train_only):
    rs = np.random.default_rng(0)
    params = {n: rs.standard_normal(s).astype(np.float32)
              for n, s in SHAPES.items()}
    cfg_kw = dict(lr=0.05, warmup_steps=2, total_steps=6, grad_clip=1.0,
                  weight_decay=0.1)
    tparams = {n: torch.from_numpy(a.copy()) for n, a in params.items()}
    tstate = adamw.init(tparams)
    jparams = {n: jnp.asarray(a) for n, a in params.items()}
    jstate = jadamw.init(jparams)
    tmask = jmask = None
    if train_only:
        tmask = adamw.trainable_mask(tparams, train_only)
        jmask = jadamw.trainable_mask(jparams, train_only)
        assert tmask == dict(jmask)
        assert sum(tmask.values()) == 2
    for step in range(3):
        # large gradients, so clipping scales them (norm >> grad_clip)
        grads = {n: (3.0 * rs.standard_normal(s)).astype(np.float32)
                 for n, s in SHAPES.items()}
        _, tstate, tm = adamw.update(
            tparams, {n: torch.from_numpy(g) for n, g in grads.items()},
            tstate, adamw.AdamWConfig(**cfg_kw), trainable=tmask)
        jparams, jstate, jm = jadamw.update(
            jparams, {n: jnp.asarray(g) for n, g in grads.items()}, jstate,
            jadamw.AdamWConfig(**cfg_kw), trainable=jmask)
        assert float(tm["grad_norm"]) > 1.0
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       **TOL)
        for n in SHAPES:
            np.testing.assert_allclose(tparams[n].numpy(),
                                       np.asarray(jparams[n]), **TOL,
                                       err_msg=n)
            for mom in ("m", "v"):
                np.testing.assert_allclose(
                    tstate[mom][n].numpy(), np.asarray(jstate[mom][n]),
                    **TOL, err_msg=f"{mom} {n}")
    assert int(tstate["step"]) == int(jstate["step"]) == 3
    if train_only:  # frozen leaves keep their values and zero moments
        assert np.array_equal(tparams["ln_f"].numpy(), params["ln_f"])
        assert not tstate["m"]["ln_f"].any()


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_schedule_lr_matches_jax(schedule):
    kw = dict(lr=3e-4, warmup_steps=5, total_steps=40, schedule=schedule)
    for step in range(0, 45, 3):
        t = adamw.schedule_lr(adamw.AdamWConfig(**kw),
                              torch.tensor(step, dtype=torch.int32))
        j = jadamw.schedule_lr(jadamw.AdamWConfig(**kw),
                               jnp.asarray(step, jnp.int32))
        np.testing.assert_allclose(float(t), float(j), **TOL)


def test_trainable_mask_selects_the_same_dit_leaves():
    """PyTorch names (`layers.3.sla_proj`, `layers.0.routing.wq`) carry
    the substrings the reference's pytree paths do."""
    import dataclasses
    cfg = get_arch("lightningdit_1b").smoke()
    cfg = dataclasses.replace(cfg, sla=cfg.sla.replace(
        routing_mode="learned"))
    model = dit.init(None, cfg, device="cpu")
    mask = adamw.trainable_mask(dict(model.named_parameters()),
                                ("routing", "sla_proj"))
    picked = sorted(n for n, t in mask.items() if t)
    assert picked == sorted(
        f"layers.{i}.{leaf}" for i in range(cfg.num_layers)
        for leaf in ("sla_proj", "routing.wq", "routing.wk"))
