"""Paged caches and chunked admission over a ("data", "model") DeviceMesh
of 1, 2 and 4 gloo ranks, against the port on one device and the
reference on one device.

One spawn a world size, the spawns at once
(`tests/_torch_mesh_paged.py`, the worker's `case_paged`), each case on
its own mesh over that world, the smoke qwen3 with
`sla.col_capacity_factor=None` (as the paged scheduler lifts it) from
the reference's perturbed init, carried over with
`repro_torch.bridge` and placed by the rules, f32 on the kernel backend
(the kernels' plain twins on these CPU tensors), caches of 128 positions
(blocks of 16):

- paged: a paged cache of two slots (one at batch 1). Slot 0 admits a
  64-token prompt at step 0 into pages 3-6, slot 1 at step 5 another
  that shares the first two pages where one data rank holds both slots
  (else its own pages), at step 8 slot 0's page of block 1 is copied on
  write, at step 17 slot 0 readmits a prompt that shares the first
  prompt's two prefix pages (rewritten by the admission), and at step 18
  slot 1 (at one slot, slot 0) readmits its prompt as a full-prompt hit
  (`insert_slot_state_paged` of `slot_state_from_prefill`: its pages
  already hold it) or, where each data rank holds its own slot, into
  pages 5 and 6, which slot 0 (the other data rank's) wrote and freed at
  step 17; 20 `decode_step`s, a fresh zeroed page whenever a slot enters
  a block (the block boundaries at 64 and 80; on (1, 4) 64 is a span
  boundary too), the table pushed by `set_page_table` before each.
  Decode-time SLA over (1, 1); (2, 2), layout A (each data rank its own
  slot's pages; `set_page_table` refuses a table that names a page of
  the other data rank's pool, and one whose page that rank's admission
  rewrote while slot 0 still names it); (1, 4), layout B (spans of two
  pages: kernel 5's partial mode); (2, 2) at one slot, layout C; dense
  decode over (1, 4) B. At step 16 (slot 0 at an appending block
  boundary) `snapshot_slots` of every slot, one more `decode_step` and
  `restore_slots` leave the paged and the per-slot cache as they were;
- chunked: a 64-token prompt admitted in chunks of 16, 32 (straddling
  the position 32: on (1, 4) a span boundary) and 16 tokens, finalized
  for a 128-position decode-SLA cache, then 4 steps; over (1, 1), (1, 2)
  A, (1, 4) B and (2, 2) at batch 1, C (each chunk's rows split over
  the two data ranks).

The tokens are the port's own f32 greedy tokens on one device, fed to
the mesh runs and to the reference, so every run scores the same
sequence. The prompts are the first of seeds 0, 1, ... whose one-device
run leads its greedy token's runner-up by MARGIN wherever a token was
chosen. The spawns start once the one-device runs have chosen the
tokens, and the reference runs in the test's process meanwhile.

Held: the logits of every admitted prompt, chunk and token, gathered
over the data ranks, within TOL x max(1, max |want|) of the port on one
device and of the reference; the mesh's and the reference's greedy
choices (every prompt's, chunk's and active slot's argmax) the fed
tokens;
every leaf of the paged cache's dense view (`paged_dense_view`) and of
the finalized chunked cache, assembled from the ranks' parts by the
rules of the cache they stand for: floats within the tolerance, integer
leaves bitwise; on every rank the paged view bitwise that rank's part
of the per-slot cache (`make_cache(per_slot=True)`, `insert_slot`) fed
the same admissions and tokens, and a restored step leaves both as
they were; the finalized cache's integer leaves
and `pos` bitwise the sharded blocking `prefill`'s, its floats within
the tolerance of them; every rank the same global records; on the 1 x 1
mesh, every logit and leaf bitwise the plain path's.
"""
import concurrent.futures
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from _torch_mesh import run_ranks, save_weights
from _torch_mesh_paged import case_cfg, run_case
from _torch_threads import one_torch_thread  # noqa: F401
from repro.configs import get_arch as jax_get_arch
from repro.models import common as jcommon
from repro.models import registry as jregistry
from repro.models import transformer as jtfm
from repro_torch import bridge
from repro_torch.configs import get_arch, get_shape
from repro_torch.distributed import ctx, sharding
from repro_torch.launch import dryrun
from repro_torch.models import transformer

LM = "qwen3-1.7b"
CACHE = 128
BLOCK = 16
TOL = 5e-5
MARGIN = 1e-3  # the port's greedy token over its runner-up
SLA = (("decode_mode", "sla"), ("col_capacity_factor", None))
DENSE = (("col_capacity_factor", None),)
POOL = 24
SCRATCH = (1, 2)
COW = 13  # slot 0's copy of its page of block 1
FRESH = 16  # the first id of the decode pages
STEPS = 20
SNAP_AT = 16  # slot 0 at an appending block boundary (80)
CHUNKS = ((0, 16), (16, 32), (48, 16))
CHUNK_STEPS = 4


@dataclasses.dataclass(frozen=True)
class Case:
    name: str
    kind: str  # "paged" or "chunked"
    mesh: tuple
    batch: int
    layout: str  # "A", "B" or "C" (distributed/serving.py)
    sla: tuple = SLA

    @property
    def world(self) -> int:
        return self.mesh[0] * self.mesh[1]

    @property
    def share(self) -> bool:
        """Whether slot 1 shares slot 0's prefix pages: one data rank
        holds both."""
        return self.batch > 1 and not (self.layout == "A"
                                       and self.mesh[0] > 1)

    @property
    def admit(self) -> tuple:
        out = [(0, 0, 0, (3, 4, 5, 6), False),
               (17, 0, 2, (3, 4, 14, 15), False)]
        if self.share:
            out += [(5, 1, 1, (3, 4, 7, 8), False),
                    (18, 1, 1, (3, 4, 7, 8), True)]
        elif self.batch > 1:  # readmitted into slot 0's freed pages 5, 6
            out += [(5, 1, 1, (9, 10, 11, 12), False),
                    (18, 1, 1, (5, 6, 11, 12), False)]
        else:
            out += [(18, 0, 2, (3, 4, 14, 15), True)]
        return tuple(sorted(out))

    @property
    def scenario(self) -> "Case":
        """What the reference's run depends on: the case without its mesh
        (cases of one scenario share that run)."""
        return dataclasses.replace(self, name="", layout="A",
                                   mesh=(1 if self.share else 2, 1))

    @property
    def tokens(self) -> int:
        return STEPS if self.kind == "paged" else CHUNK_STEPS

    def spec(self, **kw) -> dict:
        """The case as `run_case` takes it."""
        return dict(name=self.name, kind=self.kind, arch=LM,
                    mesh=list(self.mesh), batch=self.batch, cache_len=CACHE,
                    sla=dict(self.sla), pool=POOL, scratch=list(SCRATCH),
                    fresh=FRESH, admit=[[a, s, k, list(p), hit]
                                        for a, s, k, p, hit in self.admit],
                    cow=[[8, 0, 1, COW]], chunks=[list(c) for c in CHUNKS],
                    snap_at=SNAP_AT, steps=self.tokens,
                    refuse=self.kind == "paged" and not self.share
                    and self.batch > 1, **kw)


CASES = [
    Case("paged-sla-1x1", "paged", (1, 1), 2, "A"),
    Case("paged-sla-2x2", "paged", (2, 2), 2, "A"),
    Case("paged-sla-1x4", "paged", (1, 4), 2, "B"),
    Case("paged-sla-2x2-batch1", "paged", (2, 2), 1, "C"),
    Case("paged-dense-1x4", "paged", (1, 4), 2, "B", DENSE),
    Case("chunked-1x1", "chunked", (1, 1), 1, "A"),
    Case("chunked-1x2", "chunked", (1, 2), 1, "A"),
    Case("chunked-1x4", "chunked", (1, 4), 1, "B"),
    Case("chunked-2x2-batch1", "chunked", (2, 2), 1, "C"),
]


# --------------------------------------------------------------------------
# the reference on one device
# --------------------------------------------------------------------------
def _jcfg(sla: tuple):
    cfg = jax_get_arch(LM).smoke()
    return dataclasses.replace(cfg, sla=cfg.sla.replace(**dict(sla)))


@functools.lru_cache(maxsize=None)
def _weights():
    """The reference's init, perturbed (no zero-initialized tensor hides
    a path), as numpy."""
    jcfg = _jcfg(SLA)
    rs = np.random.default_rng(7)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rs.standard_normal(a.shape))
        .astype(np.float32),
        jregistry.get_model(jcfg).init(jax.random.PRNGKey(0), jcfg))


@functools.lru_cache(maxsize=None)
def _jax_fns(sla: tuple):
    jcfg = _jcfg(sla)
    dt = jnp.float32
    if jcfg.sla.decode_mode == "sla":
        prefill = jax.jit(lambda p, t: jtfm.prefill(
            p, jcfg, t, dt, "gather", decode_max_len=CACHE))
    else:  # dense decode: the prompt's K/V padded to the cache's length
        def prefill(p, t):
            hidden, cache = jax.jit(lambda p, t: jtfm.prefill(
                p, jcfg, t, dt, "gather"))(p, t)
            pad = ((0, 0),) * 3 + ((0, CACHE - t.shape[1]), (0, 0))
            return hidden, dict(cache, k=jnp.pad(cache["k"], pad),
                                v=jnp.pad(cache["v"], pad))
    step = jax.jit(lambda p, t, c: jtfm.decode_step(p, jcfg, t, c, dt))
    return prefill, step


@functools.lru_cache(maxsize=None)
def _jax_chunk():
    """The reference's `prefill_chunk` compiled once a chunk length (its
    start traced) and its `finalize_chunked_prefill`."""
    jcfg = _jcfg(SLA)
    chunk = jax.jit(lambda p, t, c, s: jtfm.prefill_chunk(
        p, jcfg, t, c, s, jnp.float32, "gather", decode_max_len=CACHE))
    final = jax.jit(lambda c: jtfm.finalize_chunked_prefill(jcfg, c, CACHE))
    return chunk, final


def prompts(case: Case, seed: int) -> dict:
    rs = np.random.default_rng([case.batch, seed, 36])
    p0 = rs.integers(0, 512, size=(1, 64)).astype(np.int32)
    tails = rs.integers(0, 512, size=(2, 32)).astype(np.int32)
    p1 = (np.concatenate([p0[:, :32], tails[:1]], 1) if case.share
          else rs.integers(0, 512, size=(1, 64)).astype(np.int32))
    return {"prompt0": p0, "prompt1": p1,
            "prompt2": np.concatenate([p0[:, :32], tails[1:]], 1)}


def _port_leaves(cache) -> dict:
    """The reference cache's leaves under the port's paths."""
    cache = dict(cache)
    out = {}
    if "sla" in cache:
        sla = dict(cache.pop("sla"))
        plan = sla.pop("plan")
        sla["plan"] = {f.name: getattr(plan, f.name)
                       for f in dataclasses.fields(plan)}
        cache["sla"] = sla
    stack = [("", cache)]
    while stack:
        prefix, tree = stack.pop()
        for k, v in tree.items():
            if isinstance(v, dict):
                stack.append((f"{prefix}{k}/", v))
                continue
            arr = np.asarray(v)
            out[f"{prefix}{k}"] = (arr.astype(np.float32)
                                   if arr.dtype.kind == "f" else arr)
    return out


def _ref_paged(case, params, inputs, feed, rec):
    jcfg = _jcfg(case.sla)
    prefill, step = _jax_fns(case.sla)
    tn = CACHE // BLOCK
    cache = jtfm.make_paged_cache(jcfg, case.batch, CACHE, POOL,
                                  dtype=jnp.float32)
    pt = np.zeros((case.batch, tn), np.int32)
    for slot in range(case.batch):
        pt[slot] = SCRATCH[slot]
    fresh, pos = FRESH, np.zeros(case.batch, np.int64)
    active, logits = set(), []
    for i in range(STEPS):
        for at, slot, k, pages, hit in case.admit:
            if at != i:
                continue
            hidden, single = prefill(params, jnp.asarray(
                inputs[f"prompt{k}"]))
            rec[f"prefill{k}"] = np.asarray(
                jcommon.logits_from_hidden(params, hidden), np.float32)
            if hit:
                cache = jtfm.insert_slot_state_paged(
                    cache, jtfm.slot_state_from_prefill(single), slot)
            else:
                cache = jtfm.insert_slot_paged(cache, single, slot,
                                               jnp.asarray(pages))
            pt[slot] = 0
            pt[slot, :len(pages)] = pages
            pos[slot] = inputs[f"prompt{k}"].shape[1]
            active.add(slot)
        if i == 8:
            cache = jtfm.copy_page(cache, COW, int(pt[0, 1]))
            pt[0, 1] = COW
        for slot in sorted(active):
            if pos[slot] % BLOCK == 0 and pos[slot] // BLOCK < tn:
                cache = jtfm.copy_page(cache, fresh, 0)
                pt[slot, pos[slot] // BLOCK] = fresh
                fresh += 1
        cache["pt"] = jnp.asarray(pt)
        lg, cache = step(params, jnp.asarray(feed[i]), cache)
        pos += 1
        logits.append(np.asarray(lg, np.float32))
    rec.update({f"view/{k}": v for k, v in _port_leaves(
        jtfm.paged_dense_view(jcfg, cache)).items()})
    return logits


def _ref_chunked(case, params, inputs, feed, rec):
    jcfg = _jcfg(case.sla)
    prefill, step = _jax_fns(case.sla)
    prompt = jnp.asarray(inputs["prompt0"])
    hidden, _ = prefill(params, prompt)
    rec["prefill0"] = np.asarray(jcommon.logits_from_hidden(params, hidden),
                                 np.float32)
    carry = jtfm.make_prefill_carry(jcfg, prompt.shape[1], jnp.float32,
                                    decode_sla=True)
    chunk, final = _jax_chunk()
    for i, (start, n) in enumerate(CHUNKS):
        carry, hidden = chunk(params, prompt[:, start:start + n], carry,
                              jnp.int32(start))
        rec[f"chunk{i}"] = np.asarray(
            jcommon.logits_from_hidden(params, hidden), np.float32)
    cache = final(carry)
    rec.update({f"final/{k}": v for k, v in _port_leaves(cache).items()})
    logits = []
    for i in range(CHUNK_STEPS):
        lg, cache = step(params, jnp.asarray(feed[i]), cache)
        logits.append(np.asarray(lg, np.float32))
    return logits


def reference(case: Case, seed: int) -> dict:
    """The reference's run of the case, fed the tokens of the port's run
    on one device (`one_device`): its records under the port's keys."""
    return _reference(case.scenario, seed)


@functools.lru_cache(maxsize=None)
def _reference(case: Case, seed: int) -> dict:
    params = jax.tree_util.tree_map(jnp.asarray, _weights())
    rec = {}
    run = _ref_paged if case.kind == "paged" else _ref_chunked
    rec["logits"] = np.stack(run(case, params, prompts(case, seed),
                                 one_device(case, seed)["feed"], rec))
    return rec


# --------------------------------------------------------------------------
# the port on one device, the prompt seed, the inputs of a case
# --------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _model_file(tmp: str) -> str:
    return save_weights(f"{tmp}/weights.npz",
                        bridge.params_from_numpy(_weights(), "cpu"))


def one_device(case: Case, seed: int) -> dict:
    """The port's run of the case on one device, on its own greedy
    tokens (records "feed", "greedy" and "chosen")."""
    return _one_device(case.scenario, seed)


@functools.lru_cache(maxsize=None)
def _one_device(case: Case, seed: int) -> dict:
    spec = case.spec()
    cfg = case_cfg(spec)
    model = transformer.init(None, cfg, device="cpu")
    model.load_state_dict(bridge.params_from_numpy(_weights(),
                                                   device="cpu"))
    return run_case(spec, model, cfg, prompts(case, seed))


@functools.lru_cache(maxsize=None)
def seed_of(case: Case) -> int:
    """The first prompt seed whose run on one device leads its greedy
    token's runner-up by MARGIN wherever a token was chosen (module
    docstring)."""
    for seed in range(16):
        top2 = np.sort(one_device(case, seed)["chosen"], axis=-1)[..., -2:]
        if (top2[..., 1] - top2[..., 0]).min() > MARGIN:
            return seed
    raise AssertionError(f"{case.name}: no prompt with a greedy margin")


def world_specs(cases, tmp_path) -> list:
    """The specs of one world's cases, their inputs (the prompts and the
    one-device run's tokens) written under `tmp_path`."""
    specs = []
    for c in cases:
        seed = seed_of(c)
        path = tmp_path / f"{c.name}.npz"
        np.savez(path, feed=one_device(c, seed)["feed"], **prompts(c, seed))
        specs.append(c.spec(inputs=str(path),
                            weights=_model_file(str(tmp_path))))
    return specs


def run_world(world, specs, tmp_path) -> dict:
    """Every case of one world in one spawn: {case name: rank 0's
    records}."""
    res = run_ranks("paged", world, tmp_path, cases=specs)
    out = {spec["name"]: {} for spec in specs}
    for key, val in res.items():
        if key != "logs":
            name, _, leaf = key.partition("/")
            out[name][leaf] = val
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{world size: {case: rank 0's records}}: the first case to ask
    starts every world's spawn at once (one thread waits for each) and
    runs the reference's cases while they run."""
    done = {}

    def get(world):
        if not done:
            worlds = sorted({c.world for c in CASES})
            jobs = {}
            for w in worlds:
                tmp = tmp_path_factory.mktemp(f"world{w}")
                jobs[w] = (world_specs([c for c in CASES if c.world == w],
                                       tmp), tmp)

            def one(w):
                try:
                    return run_world(w, *jobs[w])
                except Exception as e:  # one spawn: its cases fail
                    return e

            with concurrent.futures.ThreadPoolExecutor(len(worlds)) as ex:
                runs = {w: ex.submit(one, w) for w in worlds}
                for c in CASES:
                    reference(c, seed_of(c))
                done.update({w: run.result() for w, run in runs.items()})
        if isinstance(done[world], Exception):
            raise done[world]
        return done[world]

    return get


def _close(got, want, name):
    want = np.asarray(want, dtype=np.float32)
    atol = TOL * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got, dtype=np.float32), want,
                               atol=atol, rtol=0, err_msg=name)


@pytest.mark.parametrize("case", CASES, ids=[c.name for c in CASES])
def test_paged_caches_and_chunked_admission_over_a_mesh(case, ranks):
    got = ranks(case.world)[case.name]
    seed = seed_of(case)
    one, ref = one_device(case, seed), reference(case, seed)
    leaf = "view/" if case.kind == "paged" else "final/"
    keys = sorted(k for k in ref if k.startswith((leaf, "prefill", "chunk"))
                  and k != "view/pos_host")
    assert {f"{leaf}k", f"{leaf}pos"} <= set(keys)
    if case.sla == SLA:
        assert {f"{leaf}sla/hblk", f"{leaf}sla/plan/mc"} <= set(keys)
    assert got["logits"].shape == (case.tokens, case.batch,
                                   one["logits"].shape[-1])
    if case.world == 1:  # the 1 x 1 mesh is the plain path, bitwise
        for key in keys + ["logits"]:
            np.testing.assert_array_equal(got[key], one[key], err_msg=key)
    for want, who in ((one, "one device"), (ref, "reference")):
        _close(got["logits"], want["logits"], f"logits vs {who}")
        for key in keys:
            if want[key].dtype.kind == "f":
                _close(got[key], want[key], f"{key} vs {who}")
            else:
                np.testing.assert_array_equal(
                    np.asarray(got[key]).astype(want[key].dtype), want[key],
                    err_msg=f"{key} vs {who}")
    # the greedy tokens: every run's choice is the one-device run's feed
    sel = one["greedy"][:-1]
    for rec, who in ((got, "mesh"), (ref, "reference")):
        np.testing.assert_array_equal(rec["logits"][:-1].argmax(-1)[sel],
                                      one["feed"][1:][sel], err_msg=who)
        for key in keys:
            if key.startswith(("prefill", "chunk")):
                assert rec[key].argmax() == one[key].argmax(), (key, who)
    if case.kind == "paged":
        assert bool(got["view_bitwise"]), "a rank's view is not its part"
        assert bool(got["restore_bitwise"]), "a restored step left a trace"
        # a split sequence attends through kernel 5's partial mode
        split = case.layout in "BC" and case.sla == SLA
        calls = got["paged_partial_calls"]
        assert (calls > 0).all() if split else not calls.any()
        if case.spec()["refuse"]:
            assert got["refused"].tolist() == [True, True]
    else:
        assert bool(got["blocking_ints"]), "integer leaves vs blocking"
        assert float(got["blocking_err"]) <= TOL
        assert (got["carry_bytes"] > 0).all()
    assert bool(got["ranks_bitwise"])


# --------------------------------------------------------------------------
# a rank's pool bytes on a fake (16, 16) mesh (rank 0 of a fake process
# group): the pools keep every global page id at the rank's KV heads, so
# a rank holds P pages where its part of the per-slot cache holds its
# rows' blocks of its span (ROADMAP.md, "Differences by design")
# --------------------------------------------------------------------------
POOL_BYTES = {  # (paged pools, per-slot K/V and per-block state) a rank
    "decode_32k": (1_461_011_578_880, 5_695_864_832),
    "long_500k": (182_312_173_568, 711_983_104),
}


@pytest.mark.parametrize("shape_name", list(POOL_BYTES))
def test_a_ranks_paged_pools_hold_every_page_id(shape_name):
    """Qwen3-1.7B's decode-SLA cells on (16, 16), at the scheduler's
    default pool (a page a block of every slot, a scratch page a slot and
    the zero page): the bytes a rank's paged pools take against its part
    of the per-slot cache they stand for (made on the meta device)."""
    dryrun.fake_world(256)
    try:
        mesh = init_device_mesh("cpu", (16, 16),
                                mesh_dim_names=("data", "model"))
        cfg = get_arch("qwen3-1.7b")
        cfg = dataclasses.replace(cfg, sla=cfg.sla.replace(
            decode_mode="sla"))
        shape = get_shape(shape_name)
        b, n = shape.global_batch, shape.seq_len
        pool = 1 + b + b * (n // cfg.sla.block_kv)
        with ctx.activation_sharding(mesh, ctx.default_residual_spec(
                mesh, b, n)):
            paged = dict(sharding.tree_leaves(transformer.make_paged_cache(
                cfg, b, n, pool, device="meta")))
            slots = dict(sharding.tree_leaves(transformer.make_cache(
                cfg, b, n, per_slot=True, device="meta")))
    finally:
        dist.destroy_process_group()

    def nbytes(leaves, names):
        return sum(leaves[k].numel() * leaves[k].element_size()
                   for k in names)

    state = ("hblk", "zblk", "kpool")
    got = (nbytes(paged, ["kp", "vp"] + [f"slap/{k}" for k in state]),
           nbytes(slots, ["k", "v"] + [f"sla/{k}" for k in state]))
    assert got == POOL_BYTES[shape_name]
    assert paged["kp"].shape[1] == pool
    assert paged["kp"].shape[2] == slots["k"].shape[2]  # the rank's heads
