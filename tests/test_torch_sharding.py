"""The port's sharding rules, dry run, input specs and elastic mesh shape
against the reference's, in this process.

- Placements: for every arch of the registry on the meshes (16, 16),
  (2, 16, 16), (2, 4), (4, 2) and (4, 1), each port parameter's spec,
  placements and per-rank shape equal the reference's for its leaf (the
  stacked leaf's without its layer dim). The reference's meshes are
  `jax.sharding.AbstractMesh`es (no devices); the port's are DeviceMeshes
  over a fake process group of that many ranks.
- The dry run: every (arch x shape x single/multi) cell's per-rank
  parameter, AdamW state, batch and cache bytes equal the sum of
  `NamedSharding(AbstractMesh, spec).shard_shape` bytes of the
  reference's `abstract_state` and input specs; the skipped cells are
  the reference's.
- The registry's train, prefill and decode specs equal the reference's in
  shape and dtype; `make_concrete_batch` draws a batch of those shapes.
- `elastic.best_mesh_shape` equals the reference's on a grid of inputs.
- Qwen3 smoke's `make_prefill_step` and `make_serve_step` on bridged
  weights equal the reference's in f32 within 5e-5 x max(1, max |ref|).
"""
import ast
import math
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh

from _torch_threads import one_torch_thread  # noqa: F401
from repro.configs import get_arch as jax_get_arch
from repro.configs import get_shape as jax_get_shape
from repro.configs.base import DIT_SHAPES as J_DIT_SHAPES
from repro.distributed import elastic as jelastic
from repro.distributed import sharding as jsharding
from repro.launch import steps as jsteps
from repro.models import registry as jregistry
from repro.models import transformer as jtfm
from repro_torch import bridge
from repro_torch.configs import (ASSIGNED_ARCHS, PAPER_ARCHS, get_arch,
                                 get_shape)
from repro_torch.configs.base import DIT_SHAPES, SHAPES, ShapeConfig
from repro_torch.distributed import elastic, sharding
from repro_torch.launch import dryrun, steps
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import registry
from repro_torch.models import transformer as ttfm

ARCHS = list(ASSIGNED_ARCHS) + list(PAPER_ARCHS)
MESHES = {(16, 16): ("data", "model"), (2, 16, 16): ("pod", "data", "model"),
          (2, 4): ("data", "model"), (4, 2): ("data", "model"),
          (4, 1): ("data", "model")}
TOL = 5e-5
STACKED = re.compile(r"^(layers|enc|dec)\.\d+\.")


@pytest.fixture(scope="module", autouse=True)
def fake_meshes():
    """{mesh shape: DeviceMesh} over a fake process group of each size,
    built on demand; whatever group a case of this module leaves (the
    dry run's too) is destroyed after the module: a live one would send
    other modules' train CLIs down the mesh path."""
    from torch.distributed.device_mesh import init_device_mesh
    built = {}

    def get(shape):
        if shape not in built:
            dryrun.fake_world(math.prod(shape))
            built.clear()
            built[shape] = init_device_mesh("cpu", shape,
                                            mesh_dim_names=MESHES[shape])
        return built[shape]

    yield get
    if dist.is_initialized():
        dist.destroy_process_group()


def _norm(spec, ndim):
    """A spec (PartitionSpec or tuple) as a tuple of ndim entries."""
    out = tuple(spec) + (None,) * (ndim - len(tuple(spec)))
    return tuple(None if e is None or e == () else e for e in out)


def _ref_leaves(tree):
    return {jsharding._path_str(p): leaf
            for p, leaf in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("arch", ARCHS)
def test_param_placements_match_the_reference(arch, fake_meshes):
    jparams, _ = jsteps.abstract_state(jax_get_arch(arch))
    ref = _ref_leaves(jparams)
    params, _ = steps.abstract_state(get_arch(arch))
    for shape, axes in MESHES.items():
        jmesh = AbstractMesh(shape, axes)
        jsh = _ref_leaves(jsharding.param_shardings(jmesh, jparams))
        mesh = fake_meshes(shape)
        got = sharding.param_shardings(mesh, params)
        covered = set()
        for name, p in params.items():
            stacked = STACKED.match(name) is not None
            path = STACKED.sub(r"\1.", name).replace(".", "/")
            covered.add(path)
            leaf, jns = ref[path], jsh[path]
            want = _norm(jns.spec, len(leaf.shape))
            want_shard = jns.shard_shape(leaf.shape)
            if stacked:
                want, want_shard = want[1:], want_shard[1:]
            assert tuple(p.shape) == tuple(leaf.shape)[int(stacked):], name
            assert _norm(got[name].spec, p.ndim) == want, (shape, name)
            assert got[name].placements == sharding.spec_placements(
                want, axes), (shape, name)
            assert got[name].shard_shape(p.shape) == tuple(want_shard)
            assert tuple(sharding.place(p, got[name]).to_local().shape) \
                == tuple(want_shard), (shape, name)
        assert covered == set(ref), arch


def _bytes(shape, dtype, jns):
    return math.prod(jns.shard_shape(shape)) * np.dtype(dtype).itemsize


def _ref_cell_bytes(arch, shape_name, multi):
    """One rank's bytes of a cell on the reference's side."""
    jcfg = jax_get_arch(arch)
    shape = (J_DIT_SHAPES[arch] if arch in J_DIT_SHAPES
             else jax_get_shape(shape_name))
    jmesh = (AbstractMesh((2, 16, 16), ("pod", "data", "model")) if multi
             else AbstractMesh((16, 16), ("data", "model")))
    params, _ = jsteps.abstract_state(jcfg)
    psh = jsharding.param_shardings(jmesh, params)
    pbytes = sum(_bytes(leaf.shape, leaf.dtype, s) for leaf, s in zip(
        jax.tree_util.tree_leaves(params), jax.tree_util.tree_leaves(psh)))
    out = {"params": pbytes}
    if shape.kind == "train":
        out["opt"] = 2 * sum(
            _bytes(leaf.shape, np.float32, s) for leaf, s in zip(
                jax.tree_util.tree_leaves(params),
                jax.tree_util.tree_leaves(psh))) + 4
        batch = jregistry.train_batch_specs(jcfg, shape)
    elif shape.kind == "prefill":
        batch = jregistry.prefill_specs(jcfg, shape)
    else:
        token, cache = jregistry.decode_specs(jcfg, shape)
        tsh = jsharding.batch_shardings(jmesh, token, shape.global_batch)
        csh = jsharding.cache_shardings(jmesh, cache, shape.global_batch)
        out["batch"] = _bytes(token.shape, token.dtype, tsh)
        out["cache"] = sum(_bytes(leaf.shape, leaf.dtype, s)
                           for leaf, s in zip(
                               jax.tree_util.tree_leaves(cache),
                               jax.tree_util.tree_leaves(csh)))
        return out
    batch = {k: v for k, v in batch.items() if v is not None}
    bsh = jsharding.batch_shardings(jmesh, batch, shape.global_batch)
    out["batch"] = sum(_bytes(batch[k].shape, batch[k].dtype, bsh[k])
                       for k in batch)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_dryrun_bytes_match_the_reference(arch, tmp_path):
    shapes = ["dit"] if arch in DIT_SHAPES else list(SHAPES)
    for shape_name in shapes:
        for multi in (False, True):
            rec = dryrun.run_cell(arch, shape_name, multi, tmp_path)
            if (arch, shape_name) in dryrun.SKIPS:
                assert rec["status"] == "skipped"
                continue
            assert rec["status"] == "ok", rec.get("trace")
            assert rec["chips"] == (512 if multi else 256)
            want = _ref_cell_bytes(arch, shape_name, multi)
            assert rec["bytes_per_rank"] == want, (shape_name, multi)
    if dist.is_initialized():
        dist.destroy_process_group()


def _reference_skips() -> dict:
    """The reference dry run's SKIPS, read from its source: importing it
    would set XLA_FLAGS for this process."""
    src = (pathlib.Path(jsteps.__file__).parent / "dryrun.py").read_text()
    for node in ast.parse(src).body:
        if isinstance(node, ast.Assign) and \
                getattr(node.targets[0], "id", None) == "SKIPS":
            return ast.literal_eval(node.value)
    raise AssertionError("no SKIPS in the reference dry run")


def test_dryrun_skips_and_cli_match_the_reference(tmp_path):
    assert dryrun.SKIPS == _reference_skips()
    assert ASSIGNED_ARCHS == __import__(
        "repro.configs", fromlist=["ASSIGNED_ARCHS"]).ASSIGNED_ARCHS
    assert dryrun.main(["--arch", "lightningdit_1b", "--mesh", "single",
                        "--out", str(tmp_path)]) == 0
    assert not dist.is_initialized()
    assert (tmp_path / "lightningdit_1b__dit__single.json").exists()


def _spec_pairs(port, ref):
    """[(port (shape, dtype), ref (shape, dtype))] of two spec trees."""
    got = {p: (sharding.shape_of(v), getattr(v, "dtype", torch.int32))
           for p, v in sharding.tree_leaves(port)}
    want = {jsharding._path_str(p): (tuple(v.shape), v.dtype)
            for p, v in jax.tree_util.tree_leaves_with_path(ref)}
    return got, want


def _same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        gs, gd = got[k]
        ws, wd = want[k]
        assert gs == ws, k
        assert str(gd).replace("torch.", "") == np.dtype(wd).name, k


@pytest.mark.parametrize("arch", ARCHS)
def test_registry_specs_match_the_reference(arch):
    cfg, jcfg = get_arch(arch), jax_get_arch(arch)
    names = ["dit"] if arch in DIT_SHAPES else list(SHAPES)
    for name in names:
        shape = DIT_SHAPES[arch] if arch in DIT_SHAPES else get_shape(name)
        jshape = J_DIT_SHAPES[arch] if arch in J_DIT_SHAPES \
            else jax_get_shape(name)
        for fn in ("train_batch_specs", "prefill_specs"):
            port = getattr(registry, fn)(cfg, shape)
            ref = getattr(jregistry, fn)(jcfg, jshape)
            assert sorted(port) == sorted(ref), fn
            assert [k for k, v in port.items() if v is None] == \
                [k for k, v in ref.items() if v is None]
            _same(*_spec_pairs({k: v for k, v in port.items()
                                if v is not None},
                               {k: v for k, v in ref.items()
                                if v is not None}))
        if arch not in DIT_SHAPES and (arch, name) not in dryrun.SKIPS:
            token, cache = registry.decode_specs(cfg, shape)
            jtoken, jcache = jregistry.decode_specs(jcfg, jshape)
            _same(*_spec_pairs({"token": token, "cache": cache},
                               {"token": jtoken, "cache": jcache}))
    smoke = get_shape("train_4k", smoke=True)
    if arch in DIT_SHAPES:
        smoke = ShapeConfig("dit_smoke", 64, 2, "train")
    gen = torch.Generator().manual_seed(0)
    batch = registry.make_concrete_batch(gen, cfg.smoke(), smoke,
                                         device="cpu")
    specs = registry.train_batch_specs(cfg.smoke(), smoke)
    assert sorted(batch) == sorted(k for k, v in specs.items()
                                   if v is not None)
    for k, v in batch.items():
        assert v.shape == specs[k].shape and v.dtype == specs[k].dtype, k
    if "t" in batch:
        assert float(batch["t"].min()) >= 0 and float(batch["t"].max()) < 1


def test_best_mesh_shape_matches_the_reference():
    for n in range(1, 530):
        for mp in (1, 2, 3, 4, 6, 8, 16, 32):
            assert elastic.best_mesh_shape(n, mp) == \
                jelastic.best_mesh_shape(n, mp), (n, mp)


def _close(got, want, name):
    want = np.asarray(want, dtype=np.float32)
    atol = TOL * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got, dtype=np.float32), want,
                               atol=atol, rtol=0, err_msg=name)


@pytest.fixture(scope="module")
def qwen3_prefill():
    """Bridged weights, a prompt, and both sides' prefill step outputs."""
    jcfg = jax_get_arch("qwen3-1.7b").smoke()
    cfg = get_arch("qwen3-1.7b").smoke()
    rs = np.random.default_rng(5)
    tree = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rs.standard_normal(a.shape))
        .astype(np.float32), jtfm.init(jax.random.PRNGKey(0), jcfg))
    model = ttfm.init(None, cfg, device="cpu")
    model.load_state_dict(bridge.params_from_numpy(tree, device="cpu"))
    tokens = rs.integers(0, cfg.vocab_size, size=(2, 64)).astype(np.int32)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    orig = jtfm.prefill
    jtfm.prefill = lambda p, c, t, backend="gather": orig(
        p, c, t, jnp.float32, backend)
    try:
        jh, jc = jsteps.make_prefill_step(jcfg)(
            jparams, {"tokens": jnp.asarray(tokens)})
    finally:
        jtfm.prefill = orig
    torig = ttfm.prefill
    ttfm.prefill = lambda p, c, t, backend="gather": torig(
        p, c, t, torch.float32, backend)
    try:
        with torch.no_grad():
            th, tc = steps.make_prefill_step(cfg)(
                model, {"tokens": torch.from_numpy(tokens)})
    finally:
        ttfm.prefill = torig
    return dict(jcfg=jcfg, cfg=cfg, model=model, jparams=jparams,
                tokens=tokens, jh=jh, jc=jc, th=th, tc=tc)


def test_prefill_step_matches_the_reference(qwen3_prefill):
    r = qwen3_prefill
    _close(r["th"].numpy(), np.asarray(r["jh"]), "last hidden")
    _close(r["tc"]["k"].numpy(), np.asarray(r["jc"]["k"]), "k cache")
    _close(r["tc"]["v"].numpy(), np.asarray(r["jc"]["v"]), "v cache")
    assert r["tc"]["pos"] == int(r["jc"]["pos"]) == 64


def test_serve_step_matches_the_reference(qwen3_prefill):
    """Decode 3 tokens from the prompt's caches moved into a 128-token
    cache (`make_cache`), both sides in f32."""
    r = qwen3_prefill
    jcfg, cfg = r["jcfg"], r["cfg"]
    jcache = jtfm.make_cache(jcfg, 2, 128, dtype=jnp.float32)
    jcache = {**jcache,
              "k": jcache["k"].at[:, :, :, :64].set(r["jc"]["k"]),
              "v": jcache["v"].at[:, :, :, :64].set(r["jc"]["v"]),
              "pos": jnp.int32(64)}
    tcache = ttfm.make_cache(cfg, 2, 128, dtype=torch.float32, device="cpu")
    tcache["k"][:, :, :, :64] = r["tc"]["k"]
    tcache["v"][:, :, :, :64] = r["tc"]["v"]
    tcache["pos"] = 64
    orig, torig = jtfm.decode_step, ttfm.decode_step
    jtfm.decode_step = lambda p, c, t, cache: orig(p, c, t, cache,
                                                   jnp.float32)
    ttfm.decode_step = lambda p, c, t, cache: torig(p, c, t, cache,
                                                    torch.float32)
    try:
        jserve = jsteps.make_serve_step(jcfg)
        tserve = steps.make_serve_step(cfg)
        tok = r["tokens"][:, -1]
        for i in range(3):
            jl, jcache = jserve(r["jparams"], jnp.asarray(tok), jcache)
            with torch.no_grad():
                tl, tcache = tserve(r["model"], torch.from_numpy(tok),
                                    tcache)
            _close(tl.numpy(), np.asarray(jl), f"logits step {i}")
            tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    finally:
        jtfm.decode_step, ttfm.decode_step = orig, torig
    assert tcache["pos"] == int(jcache["pos"]) == 67


def test_production_mesh_needs_its_world():
    with pytest.raises(ValueError, match="256 ranks"):
        make_production_mesh()
