"""The gloo serving cases of tests/test_torch_mesh_serve.py and
tests/test_torch_mesh_serve_families.py: the reference's and the port's
one-device runs of each case, and one spawn a world that runs every case
of that world (`run_world`). CPU tests only (imports JAX).

A case prefills a seeded prompt (an encoder-decoder: seeded audio frames)
into caches of `cache_len` positions and decodes `STEPS` tokens. The
tokens decoded are the reference's own f32 greedy tokens (`feed`; an
encoder-decoder's first is a seeded start token), so every run, the bf16
ones too, scores the same sequence; a run's greedy tokens are then its
logits' argmax, held to the feed. The prompt is the first of seeds 0, 1,
... whose reference run leads its greedy token's runner-up by MARGIN at
every step and row, so that a difference within the tolerance cannot
flip it. The model is the family's (the reference's
`registry.get_model`), the smoke config with the case's `overrides`.
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
from repro.models import registry as jregistry
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.models import common, registry

STEPS = 6
TOL = {"float32": 5e-5, "bfloat16": 5e-2}
MARGIN = 1e-3  # the reference's greedy token over its runner-up
# the K/V leaves of each family's cache (its first names the layout)
KV_LEAVES = {"hybrid": ("attn_k", "attn_v"), "ssm": (),
             "encdec": ("self_k", "self_v", "cross_k", "cross_v")}


@dataclasses.dataclass(frozen=True)
class Case:
    name: str
    arch: str
    mesh: Tuple[int, int]
    batch: int
    prompt: int  # tokens, or an encoder-decoder's audio frames
    cache_len: int  # K/V positions (an encoder-decoder's: the frames)
    layout: str  # "A", "B" or "C" (distributed/serving.py); "-": no K/V
    dtype: str = "float32"
    per_slot: Optional[Tuple[int, ...]] = None  # decode from these pos
    overrides: Tuple[Tuple[str, object], ...] = ()  # config fields

    @property
    def world(self) -> int:
        return self.mesh[0] * self.mesh[1]

    @property
    def family(self) -> str:
        return get_arch(self.arch).family


def _jcfg(arch: str, overrides=()):
    return dataclasses.replace(jax_get_arch(arch).smoke(), **dict(overrides))


def port_cfg(arch: str, overrides=()):
    """The port's smoke config of `arch` with `overrides`."""
    return dataclasses.replace(get_arch(arch).smoke(), **dict(overrides))


def kv_leaves(family: str) -> tuple:
    return KV_LEAVES.get(family, ("k", "v"))


@functools.lru_cache(maxsize=None)
def _weights(arch: str, overrides=()):
    """The reference's init of the smoke `arch`, perturbed (so that no
    zero-initialized tensor hides a path), as numpy."""
    jcfg = _jcfg(arch, overrides)
    rs = np.random.default_rng(7)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rs.standard_normal(a.shape))
        .astype(np.float32),
        jregistry.get_model(jcfg).init(jax.random.PRNGKey(0), jcfg))


@functools.lru_cache(maxsize=None)
def _inputs(arch: str, batch: int, prompt: int, seed: int) -> dict:
    """Seeded prompt tokens (B, prompt) and, for the VLM family, patch
    embeddings (B, P, d) before them; an encoder-decoder's audio frames
    (B, prompt, d) and its start tokens (B,)."""
    cfg = get_arch(arch).smoke()
    rs = np.random.default_rng([batch, prompt, seed])
    if cfg.family == "encdec":
        return {"audio_embeds": rs.standard_normal(
                    (batch, prompt, cfg.d_model)).astype(np.float32),
                "start": rs.integers(0, cfg.vocab_size, size=(batch,))
                .astype(np.int32)}
    out = {"tokens": rs.integers(0, cfg.vocab_size, size=(batch, prompt))
           .astype(np.int32)}
    if cfg.family == "vlm":
        out["patch_embeds"] = rs.standard_normal(
            (batch, cfg.num_patches, cfg.d_model)).astype(np.float32)
    return out


def _length(c: Case) -> int:
    """The prompt's positions, patch prefix included."""
    return c.prompt + get_arch(c.arch).smoke().num_patches


def greedy(family: str, logits: np.ndarray, tokens: np.ndarray) -> tuple:
    """(the logits that chose the decoded tokens, those tokens): every
    token of an LM's run, which its prefill's or previous step's logits
    chose; an encoder-decoder's after its start token."""
    if family == "encdec":
        return logits[:STEPS - 1], tokens[1:]
    return logits[:STEPS], tokens


@functools.lru_cache(maxsize=None)
def reference(arch, overrides, batch, prompt, cache_len, per_slot, seed,
              dtype, feed=None):
    """The reference on one device: prefill (the VLM's forward with its
    prefix, an encoder-decoder's encoder and cross K/V), its K/V padded to
    `cache_len` (a per-slot `pos` when given), then one `decode_step` per
    token of `feed` (its own greedy tokens when None). Returns the logits
    (the prefill's, an LM's, then every step's), every cache leaf and the
    tokens it decoded."""
    jcfg = _jcfg(arch, overrides)
    mdl = jregistry.get_model(jcfg)
    params = jax.tree_util.tree_map(jnp.asarray, _weights(arch, overrides))
    ins = _inputs(arch, batch, prompt, seed)
    dt = getattr(jnp, dtype)
    logits = []
    if jcfg.family == "encdec":
        _, cache = mdl.prefill(params, jcfg, {"audio_embeds": jnp.asarray(
            ins["audio_embeds"])}, dt, "gather")
    elif "patch_embeds" in ins:
        x, _, (kc, vc) = mdl.forward(
            params, jcfg, jnp.asarray(ins["tokens"]),
            prefix_embeds=jnp.asarray(ins["patch_embeds"]),
            compute_dtype=dt, backend="gather", return_cache=True)
        logits.append(jcommon.logits_from_hidden(params, x[:, -1]))
        cache = {"k": kc, "v": vc, "pos": jnp.int32(kc.shape[3])}
    else:
        hidden, cache = mdl.prefill(params, jcfg,
                                    jnp.asarray(ins["tokens"]), dt, "gather")
        logits.append(jcommon.logits_from_hidden(params, hidden))
    cache = dict(cache)
    # an LM's K/V are the prompt's length (an encoder-decoder's are sized)
    for key in () if jcfg.family == "encdec" else kv_leaves(jcfg.family):
        s = cache[key].shape[3]
        cache[key] = jnp.pad(cache[key], ((0, 0),) * 3
                             + ((0, cache_len - s), (0, 0)))
    if per_slot is not None:
        cache["pos"] = jnp.asarray(per_slot, jnp.int32)
    step = jax.jit(lambda p, t, c: mdl.decode_step(p, jcfg, t, c, dt))
    toks = []
    for i in range(STEPS):
        if feed is not None:
            tok = jnp.asarray(feed[i])
        elif not logits:
            tok = jnp.asarray(ins["start"])
        else:
            tok = jnp.argmax(logits[-1], -1).astype(jnp.int32)
        toks.append(np.asarray(tok))
        lg, cache = step(params, tok, cache)
        logits.append(lg)
    out = {key: np.asarray(val, np.float32) for key, val in cache.items()
           if key != "pos"}
    return dict(out, logits=np.stack([np.asarray(x, np.float32)
                                      for x in logits]),
                tokens=np.stack(toks), pos=np.asarray(cache["pos"]))


@functools.lru_cache(maxsize=None)
def prompt_seed(c: Case) -> int:
    """The first prompt seed whose reference f32 run has the margin."""
    for seed in range(16):
        ref = reference(c.arch, c.overrides, c.batch, c.prompt, c.cache_len,
                        c.per_slot, seed, "float32")
        chose, _ = greedy(c.family, ref["logits"], ref["tokens"])
        top2 = np.sort(chose, axis=-1)[..., -2:]
        if (top2[..., 1] - top2[..., 0]).min() > MARGIN:
            return seed
    raise AssertionError(f"{c.name}: no prompt with a greedy margin")


def inputs(c: Case) -> dict:
    return _inputs(c.arch, c.batch, c.prompt, prompt_seed(c))


def reference_of(c: Case, feed=None) -> dict:
    """`reference` of the case's prompt; `feed` (STEPS, B) decoded."""
    return reference(c.arch, c.overrides, c.batch, c.prompt, c.cache_len,
                     c.per_slot, prompt_seed(c), c.dtype if feed is not None
                     else "float32",
                     None if feed is None else tuple(map(tuple,
                                                         feed.tolist())))


def feed_of(c: Case) -> np.ndarray:
    """The reference's f32 greedy tokens of the case (STEPS, B)."""
    return reference_of(c)["tokens"]


def one_device(c: Case, feed: np.ndarray) -> dict:
    """The port on one device, as the ranks run it."""
    cfg = port_cfg(c.arch, c.overrides)
    mdl = registry.get_model(cfg)
    model = mdl.init(None, cfg, device="cpu")
    model.load_state_dict(bridge.params_from_numpy(
        _weights(c.arch, c.overrides), device="cpu"))
    ins = {k: torch.from_numpy(v) for k, v in inputs(c).items()}
    dt = getattr(torch, c.dtype)
    logits = []
    with torch.no_grad():
        if cfg.family == "encdec":
            _, cache = mdl.prefill(model, cfg, ins, dt, "kernel")
        else:
            sized = ({} if cfg.family == "ssm"
                     else {"cache_len": c.cache_len})
            if cfg.family == "vlm":
                sized["prefix_embeds"] = ins["patch_embeds"]
            hidden, cache = mdl.prefill(model, cfg, ins["tokens"], dt,
                                        "kernel", **sized)
            logits.append(common.logits_from_hidden(model, hidden))
        if c.per_slot is not None:
            cache["pos"] = torch.tensor(c.per_slot, dtype=torch.int32)
            cache["pos_host"] = np.array(c.per_slot, np.int64)
        for tok in torch.from_numpy(feed):
            lg, cache = mdl.decode_step(model, cfg, tok, cache, dt)
            logits.append(lg)
    out = {key: val.float().numpy() for key, val in cache.items()
           if torch.is_tensor(val) and val.ndim >= 2}
    return dict(out, logits=torch.stack(logits).numpy(),
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
        tag = c.arch + "".join(f"-{k}{v}" for k, v in c.overrides)
        specs.append(dict(
            name=c.name, arch=c.arch, mesh=list(c.mesh),
            overrides=dict(c.overrides),
            cache_len=c.cache_len, dtype=c.dtype, inputs=str(path),
            per_slot=list(c.per_slot) if c.per_slot else None,
            weights=save_weights(tmp_path / f"{tag}.w.npz",
                                 bridge.params_from_numpy(
                                     _weights(c.arch, c.overrides),
                                     "cpu"))))
    res = run_ranks("serve", world, tmp_path, timeout=600, cases=specs)
    out = {c.name: {} for c in cases}
    for key, val in res.items():
        if key != "logs":
            name, _, leaf = key.partition("/")
            out[name][leaf] = val
    return out
