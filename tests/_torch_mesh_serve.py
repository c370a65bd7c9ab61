"""The gloo serving cases of tests/test_torch_mesh_serve.py: the
reference's and the port's one-device runs of each case, and one spawn a
world that runs every case of that world (`run_world`). CPU tests only
(imports JAX).

A case prefills a seeded prompt into caches of `cache_len` positions and
decodes `STEPS` tokens. The tokens decoded are the reference's own f32
greedy tokens (`feed`), so every run, the bf16 ones too, scores the same
sequence; a run's greedy tokens are then its logits' argmax, held to the
feed. The prompt is the first of seeds 0, 1, ... whose reference run
leads its greedy token's runner-up by MARGIN at every step and row, so
that a difference within the tolerance cannot flip it.
"""
import dataclasses
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_mesh import run_ranks, save_weights
from repro.configs import get_arch as jax_get_arch
from repro.models import common as jcommon
from repro.models import transformer as jtfm
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.models import common, transformer

STEPS = 6
TOL = {"float32": 5e-5, "bfloat16": 5e-2}
MARGIN = 1e-3  # the reference's greedy token over its runner-up


@dataclasses.dataclass(frozen=True)
class Case:
    name: str
    arch: str
    mesh: Tuple[int, int]
    batch: int
    prompt: int
    cache_len: int
    layout: str  # "A", "B" or "C" (distributed/serving.py)
    dtype: str = "float32"
    per_slot: Optional[Tuple[int, ...]] = None  # decode from these pos

    @property
    def world(self) -> int:
        return self.mesh[0] * self.mesh[1]


@functools.lru_cache(maxsize=None)
def _weights(arch: str):
    """The reference's init of the smoke `arch`, perturbed (so that no
    zero-initialized tensor hides a path), as numpy."""
    jcfg = jax_get_arch(arch).smoke()
    rs = np.random.default_rng(7)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rs.standard_normal(a.shape))
        .astype(np.float32),
        jtfm.init(jax.random.PRNGKey(0), jcfg))


@functools.lru_cache(maxsize=None)
def _inputs(arch: str, batch: int, prompt: int, seed: int) -> dict:
    """Seeded prompt tokens (B, prompt) and, for the VLM family, patch
    embeddings (B, P, d) before them."""
    cfg = get_arch(arch).smoke()
    rs = np.random.default_rng([batch, prompt, seed])
    out = {"tokens": rs.integers(0, cfg.vocab_size, size=(batch, prompt))
           .astype(np.int32)}
    if cfg.family == "vlm":
        out["patch_embeds"] = rs.standard_normal(
            (batch, cfg.num_patches, cfg.d_model)).astype(np.float32)
    return out


def _length(c: Case) -> int:
    """The prompt's positions, patch prefix included."""
    return c.prompt + get_arch(c.arch).smoke().num_patches


@functools.lru_cache(maxsize=None)
def reference(arch, batch, prompt, cache_len, per_slot, seed, dtype,
              feed=None):
    """The reference on one device: prefill (the VLM's forward with its
    prefix), its caches padded to `cache_len` (a per-slot `pos` when
    given), then one `decode_step` per token of `feed` (its own greedy
    tokens when None). Returns logits (1 + STEPS, B, V), k, v and the
    tokens it decoded."""
    jcfg = jax_get_arch(arch).smoke()
    params = jax.tree_util.tree_map(jnp.asarray, _weights(arch))
    ins = _inputs(arch, batch, prompt, seed)
    dt = getattr(jnp, dtype)
    tokens = jnp.asarray(ins["tokens"])
    if "patch_embeds" in ins:
        x, _, (kc, vc) = jtfm.forward(
            params, jcfg, tokens, prefix_embeds=jnp.asarray(
                ins["patch_embeds"]), compute_dtype=dt, backend="gather",
            return_cache=True)
        hidden = x[:, -1]
    else:
        hidden, pc = jtfm.prefill(params, jcfg, tokens, dt, "gather")
        kc, vc = pc["k"], pc["v"]
    s = kc.shape[3]
    pad = ((0, 0),) * 3 + ((0, cache_len - s), (0, 0))
    cache = {"k": jnp.pad(kc, pad), "v": jnp.pad(vc, pad),
             "pos": (jnp.int32(s) if per_slot is None
                     else jnp.asarray(per_slot, jnp.int32))}
    step = jax.jit(lambda p, t, c: jtfm.decode_step(p, jcfg, t, c, dt))
    logits = [jcommon.logits_from_hidden(params, hidden)]
    toks = []
    for i in range(STEPS):
        tok = (jnp.argmax(logits[-1], -1).astype(jnp.int32) if feed is None
               else jnp.asarray(feed[i]))
        toks.append(np.asarray(tok))
        lg, cache = step(params, tok, cache)
        logits.append(lg)
    return dict(logits=np.stack([np.asarray(x, np.float32) for x in logits]),
                k=np.asarray(cache["k"], np.float32),
                v=np.asarray(cache["v"], np.float32),
                tokens=np.stack(toks), pos=np.asarray(cache["pos"]))


@functools.lru_cache(maxsize=None)
def prompt_seed(c: Case) -> int:
    """The first prompt seed whose reference f32 run has the margin."""
    for seed in range(16):
        ref = reference(c.arch, c.batch, c.prompt, c.cache_len, c.per_slot,
                        seed, "float32")
        top2 = np.sort(ref["logits"][:STEPS], axis=-1)[..., -2:]
        if (top2[..., 1] - top2[..., 0]).min() > MARGIN:
            return seed
    raise AssertionError(f"{c.name}: no prompt with a greedy margin")


def inputs(c: Case) -> dict:
    return _inputs(c.arch, c.batch, c.prompt, prompt_seed(c))


def reference_of(c: Case, feed=None) -> dict:
    """`reference` of the case's prompt; `feed` (STEPS, B) decoded."""
    return reference(c.arch, c.batch, c.prompt, c.cache_len, c.per_slot,
                     prompt_seed(c), c.dtype if feed is not None
                     else "float32",
                     None if feed is None else tuple(map(tuple,
                                                         feed.tolist())))


def feed_of(c: Case) -> np.ndarray:
    """The reference's f32 greedy tokens of the case (STEPS, B)."""
    return reference_of(c)["tokens"]


def one_device(c: Case, feed: np.ndarray) -> dict:
    """The port on one device, as the ranks run it."""
    cfg = get_arch(c.arch).smoke()
    model = transformer.init(None, cfg, device="cpu")
    model.load_state_dict(bridge.params_from_numpy(_weights(c.arch),
                                                   device="cpu"))
    ins = {k: torch.from_numpy(v) for k, v in inputs(c).items()}
    dt = getattr(torch, c.dtype)
    with torch.no_grad():
        hidden, cache = transformer.prefill(
            model, cfg, ins["tokens"], dt, "kernel", cache_len=c.cache_len,
            prefix_embeds=ins.get("patch_embeds"))
        if c.per_slot is not None:
            cache["pos"] = torch.tensor(c.per_slot, dtype=torch.int32)
            cache["pos_host"] = np.array(c.per_slot, np.int64)
        logits = [common.logits_from_hidden(model, hidden)]
        for tok in torch.from_numpy(feed):
            lg, cache = transformer.decode_step(model, cfg, tok, cache, dt)
            logits.append(lg)
    return dict(logits=torch.stack(logits).numpy(),
                k=cache["k"].float().numpy(), v=cache["v"].float().numpy(),
                pos=np.asarray(cache["pos"]))


def run_world(cases, tmp_path) -> dict:
    """Every case of one world in one spawn of that many gloo ranks:
    {case name: {key: array}} of rank 0's records (`case_serve`)."""
    world = cases[0].world
    specs = []
    for c in cases:
        assert c.world == world
        path = tmp_path / f"{c.name}.npz"
        np.savez(path, feed=feed_of(c), **inputs(c))
        specs.append(dict(
            name=c.name, arch=c.arch, mesh=list(c.mesh),
            cache_len=c.cache_len, dtype=c.dtype, inputs=str(path),
            per_slot=list(c.per_slot) if c.per_slot else None,
            weights=save_weights(tmp_path / f"{c.arch}.w.npz",
                                 bridge.params_from_numpy(
                                     _weights(c.arch), "cpu"))))
    res = run_ranks("serve", world, tmp_path, timeout=600, cases=specs)
    out = {c.name: {} for c in cases}
    for key, val in res.items():
        if key != "logs":
            name, _, leaf = key.partition("/")
            out[name][leaf] = val
    return out
