"""The gloo cases of tests/test_torch_mesh_decode_sla.py and
tests/test_torch_mesh_decode_sla_cell.py: the reference's and the port's
one-device decode-time SLA runs of each case, one spawn a world that
runs every case of that world (`worlds`), and what a case holds
(`check_case`). CPU tests only (imports JAX).

A case prefills a seeded prompt of PROMPT tokens with
`prefill(decode_max_len=CACHE)` (the decode-SLA state seeded) and takes
STEPS `decode_step`s, which cross the block boundaries at 64, 80 and 96
(smoke blocks of 16). The tokens decoded are the reference's own f32
greedy tokens (`feed`), so every run, the bf16 ones too, scores the same
sequence. The prompt is the first of seeds 0, 1, ... whose reference run
leads its greedy token's runner-up by MARGIN at every step and row, and
whose port run on one device plans as the reference does (every integer
leaf of the state bitwise: no near-tied block; a bf16 case's in bf16
too), so that a difference within the tolerance flips neither. The config is the smoke one with
`sla.decode_mode="sla"` (the reference's decode cell).
"""
import dataclasses
import functools
import json
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_mesh import run_ranks, save_weights
from _torch_mesh_serve import _weights
from repro.configs import get_arch as jax_get_arch
from repro.models import common as jcommon
from repro.models import registry as jregistry
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.distributed import sharding
from repro_torch.models import common, registry

STEPS = 40
PROMPT, CACHE = 64, 128
TOL = {"float32": 5e-5, "bfloat16": 5e-2}
MARGIN = 1e-3  # the reference's greedy token over its runner-up


@dataclasses.dataclass(frozen=True)
class Case:
    name: str
    arch: str
    mesh: Tuple[int, int]
    batch: int
    layout: str  # "A", "B" or "C" (distributed/serving.py)
    dtype: str = "float32"

    @property
    def world(self) -> int:
        return self.mesh[0] * self.mesh[1]


def jax_cfg(arch: str):
    c = jax_get_arch(arch).smoke()
    return dataclasses.replace(c, sla=c.sla.replace(decode_mode="sla"))


def port_cfg(arch: str):
    c = get_arch(arch).smoke()
    return dataclasses.replace(c, sla=c.sla.replace(decode_mode="sla"))


def tokens_of(arch: str, batch: int, seed: int) -> np.ndarray:
    rs = np.random.default_rng([batch, PROMPT, seed, 21])
    return rs.integers(0, get_arch(arch).smoke().vocab_size,
                       size=(batch, PROMPT)).astype(np.int32)


def leaves(cache) -> dict:
    """{path: float32 or int array} of a cache's tensors ("k", "v",
    "sla/hblk", "sla/plan/mc", ...; `rows` and `pos` as arrays too)."""
    out = {}
    for path, leaf in sharding.tree_leaves(cache):
        if torch.is_tensor(leaf):
            leaf = leaf.detach()
            leaf = (leaf.float() if leaf.is_floating_point()
                    else leaf).numpy()
        arr = np.asarray(leaf)
        if arr.dtype.kind == "f":
            arr = arr.astype(np.float32)
        out[path] = arr
    return out


@functools.lru_cache(maxsize=None)
def _jax_fns(arch: str, dtype: str):
    jcfg = jax_cfg(arch)
    mdl = jregistry.get_model(jcfg)
    dt = getattr(jnp, dtype)
    prefill = jax.jit(lambda p, t: mdl.prefill(p, jcfg, t, dt, "gather",
                                               decode_max_len=CACHE))
    step = jax.jit(lambda p, t, c: mdl.decode_step(p, jcfg, t, c, dt))
    return prefill, step


def _ref_leaves(cache) -> dict:
    """The reference cache's leaves under the port's paths."""
    cache = dict(cache)
    sla = dict(cache.pop("sla"))
    plan = sla.pop("plan")
    tree = dict(cache, sla=dict(sla, plan={
        f.name: getattr(plan, f.name) for f in dataclasses.fields(plan)}))
    out = {}
    for path, leaf in sharding.tree_leaves(tree):
        arr = np.asarray(leaf)
        out[path] = (arr.astype(np.float32)
                     if jnp.issubdtype(arr.dtype, jnp.floating) else arr)
    return out


@functools.lru_cache(maxsize=None)
def reference(arch: str, batch: int, seed: int, dtype: str, feed=None):
    """The reference on one device: prefill(decode_max_len=CACHE), then
    one decode_step per token of `feed` (its own greedy tokens when
    None). Returns the logits (the prefill's, then every step's), every
    cache leaf and the tokens it decoded."""
    params = jax.tree_util.tree_map(jnp.asarray, _weights(arch, ()))
    prefill, step = _jax_fns(arch, dtype)
    hidden, cache = prefill(params,
                            jnp.asarray(tokens_of(arch, batch, seed)))
    logits = [jcommon.logits_from_hidden(params, hidden)]
    toks = []
    for i in range(STEPS):
        tok = (jnp.asarray(feed[i]) if feed is not None
               else jnp.argmax(logits[-1], -1).astype(jnp.int32))
        toks.append(np.asarray(tok))
        lg, cache = step(params, tok, cache)
        logits.append(lg)
    return dict(_ref_leaves(cache), logits=np.stack(
        [np.asarray(x, np.float32) for x in logits]),
        tokens=np.stack(toks))


@functools.lru_cache(maxsize=None)
def _one_device(arch: str, batch: int, seed: int, dtype: str, feed):
    cfg = port_cfg(arch)
    mdl = registry.get_model(cfg)
    model = mdl.init(None, cfg, device="cpu")
    model.load_state_dict(bridge.params_from_numpy(_weights(arch, ()),
                                                   device="cpu"))
    dt = getattr(torch, dtype)
    with torch.no_grad():
        tokens = torch.from_numpy(tokens_of(arch, batch, seed))
        hidden, cache = mdl.prefill(model, cfg, tokens, dt, "kernel",
                                    decode_max_len=CACHE)
        logits = [common.logits_from_hidden(model, hidden)]
        for tok in torch.tensor(feed):
            lg, cache = mdl.decode_step(model, cfg, tok, cache, dt,
                                        backend="kernel")
            logits.append(lg)
    return dict(leaves(cache), logits=torch.stack(logits).float().numpy())


def int_leaves(out: dict) -> list:
    return [k for k, v in out.items()
            if k.startswith("sla/") and v.dtype.kind in "iub"]


@functools.lru_cache(maxsize=None)
def prompt_seed(arch: str, batch: int, dtype: str) -> int:
    """The first prompt seed whose reference f32 run has the margin and
    that plans alike in the reference's and the one-device port's f32
    runs, and for a bf16 case in their bf16 runs too (a bf16 run's
    rounding moves near-tied drift decisions that f32 keeps)."""
    dtypes = ("float32",) + (("bfloat16",) if dtype == "bfloat16" else ())
    for seed in range(16):
        ref = reference(arch, batch, seed, "float32")
        top2 = np.sort(ref["logits"][:STEPS], axis=-1)[..., -2:]
        if (top2[..., 1] - top2[..., 0]).min() <= MARGIN:
            continue
        feed = tuple(map(tuple, ref["tokens"].tolist()))
        runs = [run(arch, batch, seed, dt, feed) for dt in dtypes
                for run in (reference, _one_device)]
        if all(np.array_equal(r[k], ref[k]) for r in runs
               for k in int_leaves(ref)):
            return seed
    raise AssertionError(f"{arch} batch {batch}: no prompt with a greedy "
                         f"margin that plans alike")


def seed_of(c: Case) -> int:
    return prompt_seed(c.arch, c.batch, c.dtype)


def feed_of(c: Case) -> np.ndarray:
    """The reference's f32 greedy tokens of the case (STEPS, B)."""
    return reference(c.arch, c.batch, seed_of(c), "float32")["tokens"]


def reference_of(c: Case) -> dict:
    feed = tuple(map(tuple, feed_of(c).tolist()))
    return reference(c.arch, c.batch, seed_of(c), c.dtype, feed)


def one_device(c: Case) -> dict:
    feed = tuple(map(tuple, feed_of(c).tolist()))
    return _one_device(c.arch, c.batch, seed_of(c), c.dtype, feed)


def run_world(cases, tmp_path) -> dict:
    """Every case of one world in one spawn of that many gloo ranks:
    {case name: {key: array}} of rank 0's records (`case_serve_sla`)."""
    world = cases[0].world
    specs = []
    for c in cases:
        assert c.world == world
        path = tmp_path / f"{c.name}.npz"
        np.savez(path, feed=feed_of(c),
                 tokens=tokens_of(c.arch, c.batch, seed_of(c)))
        specs.append(dict(
            name=c.name, arch=c.arch, mesh=list(c.mesh), cache_len=CACHE,
            dtype=c.dtype, inputs=str(path),
            weights=save_weights(tmp_path / f"{c.arch}.w.npz",
                                 bridge.params_from_numpy(
                                     _weights(c.arch, ()), "cpu"))))
    res = run_ranks("serve_sla", world, tmp_path, timeout=600, cases=specs)
    out = {c.name: {} for c in cases}
    for key, val in res.items():
        if key != "logs":
            name, _, leaf = key.partition("/")
            out[name][leaf] = val
    return out


def worlds(cases):
    """A module fixture named `ranks`: {world size: {case: rank 0's
    records}}, one spawn a world size of `cases`, run when its first case
    asks."""
    @pytest.fixture(scope="module", name="ranks")
    def fixture(tmp_path_factory):
        done = {}

        def get(world):
            if world not in done:
                try:
                    done[world] = run_world(
                        [c for c in cases if c.world == world],
                        tmp_path_factory.mktemp(f"world{world}"))
                except Exception as e:  # one spawn: every case of it fails
                    done[world] = e
            if isinstance(done[world], Exception):
                raise done[world]
            return done[world]

        return get

    return fixture


def _close(got, want, tol, name):
    want = np.asarray(want, dtype=np.float32)
    atol = tol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got, dtype=np.float32), want,
                               atol=atol, rtol=0, err_msg=name)


def check_case(case: Case, got: dict) -> None:
    """What a case holds (the test modules' docstring): rank 0's records
    `got` against the port on one device and the reference."""
    cfg = get_arch(case.arch).smoke()
    tol = TOL[case.dtype]
    one, ref = one_device(case), reference_of(case)
    # the layout the rules gave the K/V
    spec = json.loads(str(got["spec/k"]))
    model = case.mesh[1]
    if case.world > 1:
        assert spec[3] == {"A": None, "B": "model",
                           "C": "data" if cfg.num_kv_heads % model == 0
                           else ["data", "model"]}[case.layout], spec
    leaves = sorted(k for k in one if k != "logits")
    assert {"sla/hblk", "sla/plan/mc", "sla/live_lut"} <= set(leaves)
    if case.world == 1:  # the 1 x 1 mesh is the plain path, bitwise
        np.testing.assert_array_equal(got["logits"], one["logits"])
        for key in leaves:
            np.testing.assert_array_equal(got[key], one[key], err_msg=key)
    for want, who in ((one, "one device"), (ref, "reference")):
        _close(got["logits"], want["logits"], tol, f"logits vs {who}")
        for key in leaves:
            if want[key].dtype.kind == "f":
                _close(got[key], want[key], tol, f"{key} vs {who}")
            else:
                np.testing.assert_array_equal(got[key], want[key],
                                              err_msg=f"{key} vs {who}")
    if case.dtype == "float32":
        np.testing.assert_array_equal(got["logits"][:STEPS].argmax(-1),
                                      feed_of(case))
    assert bool(got["replicated_bitwise"])
    assert bool(got["leaves_bitwise"])
    assert int(got["empty_bytes"]) == int(got["dryrun_bytes"])
    if case.dtype == "bfloat16":
        assert int(got["cache_bytes"]) == int(got["dryrun_bytes"])
