"""Continuous-batching decode over a ("data", "model") DeviceMesh of 1, 2
and 4 gloo ranks: per-slot positions on a decode-SLA cache with slot
admission, `decode_chunk`, and learned routing in the decode step,
against the port on one device and the reference on one device.

One spawn a world size (`tests/_torch_mesh_slots.py`, the worker's
`case_slots`), each case on its own mesh over that world, the smoke
qwen3 with `sla.decode_mode="sla"` from the reference's perturbed init
(its learned-routing scorer too), carried over with `repro_torch.bridge`
and placed by the rules, f32 on the kernel backend (the kernels' plain
twins on these CPU tensors), cache of 128 positions (blocks of 16):

- slots: a per-slot cache of two slots; slot 0 admits a 64-token prompt
  at step 0, slot 1 a 48-token one at step 5 (so their block boundaries
  fall on different steps; slot 1 decodes empty before it), and at step
  24 slot 0 readmits a 32-token prompt with `insert_slot` while slot 1
  keeps decoding; 36 steps. Each prefill runs at batch 1 under the mesh
  (the sequence over "data") and `insert_slot` moves it into the batch's
  placement. Over (1, 1); (2, 2), layout A; (1, 4), layout B (spans of
  32 positions: the slots' in-flight blocks on different span ranks);
  (2, 2) at one slot, layout C;
- chunk: `prefill(decode_max_len=128)` of a 64-token prompt, 12
  `decode_step`s, three `decode_chunk`s of 8 (76-83 crosses the block
  boundary at 80; 92-99 the one at 96, on (1, 4) a span boundary too),
  4 steps; over (1, 2) A, (1, 4) B and (2, 2) at batch 1, C; and the
  dense cache (`cache_len=128`) over (1, 4);
- learned: `routing_mode="learned"`, 17 steps from 64 (block boundaries
  at 64 and 80), over (1, 2) A and (1, 4) B.

The tokens are the reference's own f32 greedy tokens (one token at a
time; a slot idle before its admission decodes token 0), so every run
scores the same sequence: a chunk verifies the drafts the steps chose.
The prompts are the first of seeds 0, 1, ... whose reference run leads
its greedy token's runner-up by MARGIN wherever a token was chosen and
whose runs (the reference's, the port's on one device, and for a chunk
case the port's steps in its place) plan alike: every integer leaf of
the state bitwise, no near-tied block.

Held: the logits of every admitted prompt and of every token, gathered
over the data ranks, within TOL x max(1, max |want|) of the port on one
device and of the reference (a chunk case's also of C one-device
`decode_step`s); the greedy tokens equal the reference's; every leaf of
the cache and of its "sla" state, assembled from the ranks' parts by the
rule's spec: floats within the tolerance, integer leaves (the plan, the
live row, the counters, `rows`, `pos`) bitwise; every rank holds the
same global records and the ranks that hold the same shard of a leaf the
same bits (so every rank took the same drift decisions); on the 1 x 1
mesh, every logit and leaf bitwise the plain path's.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_mesh import run_ranks, save_weights
from _torch_mesh_slots import case_cfg, run_case
from _torch_threads import one_torch_thread  # noqa: F401
from repro.configs import get_arch as jax_get_arch
from repro.models import common as jcommon
from repro.models import registry as jregistry
from repro.models import transformer as jtfm
from repro_torch import bridge
from repro_torch.models import transformer

LM = "qwen3-1.7b"
CACHE = 128
TOL = 5e-5
MARGIN = 1e-3  # the reference's greedy token over its runner-up
SLA = (("decode_mode", "sla"),)
LEARNED = SLA + (("routing_mode", "learned"),)
PROMPTS = (64, 48, 32)  # prompt i's tokens (slots); chunk/learned: 0
ADMIT = ((0, 0, 0), (5, 1, 1), (24, 0, 2))  # (step, slot, prompt)
ADMIT_ONE = ((0, 0, 0), (20, 0, 2))  # one slot
SLOT_STEPS = 36
CHUNK_OPS = (("step", 12), ("chunk", 8), ("chunk", 8), ("chunk", 8),
             ("step", 4))
LEARNED_OPS = (("step", 17),)


@dataclasses.dataclass(frozen=True)
class Case:
    name: str
    kind: str  # "slots" or "static"
    mesh: tuple
    batch: int
    layout: str  # "A", "B" or "C" (distributed/serving.py)
    sla: tuple = SLA  # SLAConfig fields
    ops: tuple = ()

    @property
    def world(self) -> int:
        return self.mesh[0] * self.mesh[1]

    @property
    def admit(self) -> tuple:
        return ADMIT if self.batch > 1 else ADMIT_ONE

    @property
    def tokens(self) -> int:
        return SLOT_STEPS if self.kind == "slots" else sum(
            n for _, n in self.ops)

    def spec(self, **kw) -> dict:
        """The case as `run_case` takes it."""
        return dict(name=self.name, kind=self.kind, arch=LM,
                    mesh=list(self.mesh), batch=self.batch, cache_len=CACHE,
                    sla=dict(self.sla), admit=[list(a) for a in self.admit],
                    ops=[list(o) for o in self.ops], **kw)


def _slots(name, mesh, batch, layout):
    return Case(name, "slots", mesh, batch, layout)


def _static(name, mesh, batch, layout, sla=SLA, ops=CHUNK_OPS):
    return Case(name, "static", mesh, batch, layout, sla, ops)


CASES = [
    _slots("slots-1x1", (1, 1), 2, "A"),
    _slots("slots-2x2", (2, 2), 2, "A"),
    _slots("slots-1x4", (1, 4), 2, "B"),
    _slots("slots-2x2-batch1", (2, 2), 1, "C"),
    _static("chunk-1x2", (1, 2), 2, "A"),
    _static("chunk-1x4", (1, 4), 2, "B"),
    _static("chunk-2x2-batch1", (2, 2), 1, "C"),
    _static("chunk-dense-1x4", (1, 4), 2, "B", sla=()),
    _static("learned-1x2", (1, 2), 2, "A", LEARNED, LEARNED_OPS),
    _static("learned-1x4", (1, 4), 2, "B", LEARNED, LEARNED_OPS),
]


# --------------------------------------------------------------------------
# the reference on one device
# --------------------------------------------------------------------------
def _jcfg(sla: tuple):
    cfg = jax_get_arch(LM).smoke()
    return dataclasses.replace(cfg, sla=cfg.sla.replace(**dict(sla)))


@functools.lru_cache(maxsize=None)
def _weights(sla: tuple):
    """The reference's init of the case's config (its scorer under learned
    routing), perturbed (no zero-initialized tensor hides a path), as
    numpy."""
    jcfg = _jcfg(sla)
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
    chunk = jax.jit(lambda p, t, c: jtfm.decode_chunk(p, jcfg, t, c, dt))
    return prefill, step, chunk


def prompts(case: Case, seed: int) -> dict:
    rs = np.random.default_rng([case.batch, seed, 33])
    if case.kind == "slots":
        return {f"prompt{i}": rs.integers(0, 512, size=(1, n))
                .astype(np.int32) for i, n in enumerate(PROMPTS)}
    return {"prompt0": rs.integers(0, 512, size=(case.batch, PROMPTS[0]))
            .astype(np.int32)}


def _leaves(cache) -> dict:
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
            out[f"cache/{prefix}{k}"] = (
                arr.astype(np.float32) if arr.dtype.kind == "f" else arr)
    return out


def _argmax(x):
    return np.asarray(jnp.argmax(x, -1)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def reference(case: Case, seed: int, steps_only: bool = False) -> dict:
    """The reference's run of the case (`steps_only`: a chunk's tokens
    one `decode_step` at a time, each the previous logits' greedy token):
    its logits, every cache leaf, the tokens it fed (`feed`), which step
    logits chose the next step's token (`greedy`, (tokens, B)) and every
    logits row that chose a fed token (`chosen`)."""
    if case.kind == "slots" and not steps_only:
        return reference(case, seed, True)
    params = jax.tree_util.tree_map(jnp.asarray, _weights(case.sla))
    prefill, step, chunk = _jax_fns(case.sla)
    inputs = prompts(case, seed)
    rec, chosen, logits, feed = {}, [], [], []
    greedy = np.zeros((case.tokens, case.batch), bool)
    if case.kind == "slots":
        cache = jtfm.make_cache(_jcfg(case.sla), case.batch, CACHE,
                                dtype=jnp.float32, decode_sla=True,
                                per_slot=True)
        tok = np.zeros((case.batch,), np.int32)
        for i in range(SLOT_STEPS):
            for at, slot, k in case.admit:
                if at == i:
                    hidden, single = prefill(params, jnp.asarray(
                        inputs[f"prompt{k}"]))
                    lg = jcommon.logits_from_hidden(params, hidden)
                    rec[f"prefill{k}"] = np.asarray(lg, np.float32)
                    cache = jtfm.insert_slot(cache, single, slot)
                    tok[slot] = _argmax(lg)[0]
                    chosen.append(np.asarray(lg[0]))
                    if i:
                        greedy[i - 1, slot] = False
            feed.append(tok.copy())
            lg, cache = step(params, jnp.asarray(tok), cache)
            logits.append(np.asarray(lg, np.float32))
            greedy[i] = [any(at <= i and s == slot
                             for at, slot, _ in case.admit)
                         for s in range(case.batch)]
            tok = np.where(greedy[i], _argmax(lg), 0).astype(np.int32)
    else:
        hidden, cache = prefill(params, jnp.asarray(inputs["prompt0"]))
        lg = jcommon.logits_from_hidden(params, hidden)
        rec["prefill0"] = np.asarray(lg, np.float32)
        chosen.extend(np.asarray(lg))
        greedy[:] = True
        given = None if steps_only else reference(case, seed, True)["feed"]
        tok = _argmax(lg)
        at = 0
        for op, n in case.ops:
            if op == "chunk" and not steps_only:
                toks = given[at:at + n]
                lg, cache = chunk(params, jnp.asarray(toks.T), cache)
                logits.extend(np.asarray(lg, np.float32).transpose(1, 0, 2))
                feed.extend(toks)
                at += n
                continue
            for _ in range(n):
                feed.append(tok if given is None else given[at])
                lg, cache = step(params, jnp.asarray(feed[-1]), cache)
                logits.append(np.asarray(lg, np.float32))
                tok = _argmax(lg)
                at += 1
    greedy[-1] = False  # the last logits choose no fed token
    rec.update(_leaves(cache))
    rec["logits"] = np.stack(logits)
    rec["feed"] = np.stack(feed).astype(np.int32)
    rec["greedy"] = greedy
    rec["chosen"] = np.concatenate([np.stack(chosen).reshape(
        -1, rec["logits"].shape[-1]), rec["logits"][greedy]])
    return rec


# --------------------------------------------------------------------------
# the port on one device, the prompt seed, the inputs of a case
# --------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _model_file(sla: tuple, tmp: str) -> str:
    return save_weights(f"{tmp}/w{len(sla)}.npz", bridge.params_from_numpy(
        _weights(sla), "cpu"))


@functools.lru_cache(maxsize=None)
def one_device(case: Case, seed: int, steps_only: bool = False) -> dict:
    """The port's run of the case on one device (`steps_only`: a chunk's
    tokens one `decode_step` at a time)."""
    if case.kind == "slots" and not steps_only:
        return one_device(case, seed, True)
    spec = case.spec(steps_only=steps_only)
    cfg = case_cfg(spec)
    model = transformer.init(None, cfg, device="cpu")
    model.load_state_dict(bridge.params_from_numpy(_weights(case.sla),
                                                   device="cpu"))
    inputs = dict(prompts(case, seed), feed=reference(case, seed, True)[
        "feed"])
    return run_case(spec, model, cfg, inputs)


def _int_leaves(rec: dict) -> list:
    return [k for k, v in rec.items()
            if k.startswith("cache/sla/") and v.dtype.kind in "iub"]


@functools.lru_cache(maxsize=None)
def seed_of(case: Case) -> int:
    """The first prompt seed with the margin that plans alike (module
    docstring)."""
    for seed in range(16):
        ref = reference(case, seed, True)
        top2 = np.sort(ref["chosen"], axis=-1)[..., -2:]
        if (top2[..., 1] - top2[..., 0]).min() <= MARGIN:
            continue
        runs = [ref, reference(case, seed), one_device(case, seed),
                one_device(case, seed, True)]
        if all(np.array_equal(r[k], ref[k]) for r in runs
               for k in _int_leaves(ref)):
            return seed
    raise AssertionError(f"{case.name}: no prompt with a greedy margin "
                         f"that plans alike")


def run_world(cases, tmp_path) -> dict:
    """Every case of one world in one spawn: {case name: rank 0's
    records}."""
    world = cases[0].world
    specs = []
    for c in cases:
        seed = seed_of(c)
        path = tmp_path / f"{c.name}.npz"
        np.savez(path, feed=reference(c, seed, True)["feed"],
                 **prompts(c, seed))
        specs.append(c.spec(inputs=str(path),
                            weights=_model_file(c.sla, str(tmp_path))))
    res = run_ranks("slots", world, tmp_path, timeout=600, cases=specs)
    out = {c.name: {} for c in cases}
    for key, val in res.items():
        if key != "logs":
            name, _, leaf = key.partition("/")
            out[name][leaf] = val
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{world size: {case: rank 0's records}}, one spawn a world size, run
    when its first case asks."""
    done = {}

    def get(world):
        if world not in done:
            try:
                done[world] = run_world(
                    [c for c in CASES if c.world == world],
                    tmp_path_factory.mktemp(f"world{world}"))
            except Exception as e:  # one spawn: every case of it fails
                done[world] = e
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
def test_continuous_batching_decode_over_a_mesh(case, ranks):
    got = ranks(case.world)[case.name]
    seed = seed_of(case)
    one, ref = one_device(case, seed), reference(case, seed)
    if case.world > 1:  # the layout the rules gave the K/V
        seq = eval(str(got["spec/k"]))[3]
        assert seq == {"A": None, "B": "model", "C": "data"}[case.layout]
    keys = sorted(k for k in one if k.startswith(("cache/", "prefill")))
    assert {"cache/k", "cache/pos"} <= set(keys)
    if case.sla:
        assert {"cache/sla/hblk", "cache/sla/plan/mc",
                "cache/sla/extends"} <= set(keys)
    assert got["logits"].shape == (case.tokens, case.batch,
                                   one["logits"].shape[-1])
    if case.world == 1:  # the 1 x 1 mesh is the plain path, bitwise
        for key in keys + ["logits"]:
            np.testing.assert_array_equal(got[key], one[key], err_msg=key)
    wants = [(one, "one device"), (ref, "reference")]
    if case.kind == "static":
        wants.append((one_device(case, seed, True), "one-device steps"))
    for want, who in wants:
        _close(got["logits"], want["logits"], f"logits vs {who}")
        for key in keys:
            if want[key].dtype.kind == "f":
                _close(got[key], want[key], f"{key} vs {who}")
            else:
                np.testing.assert_array_equal(got[key], want[key],
                                              err_msg=f"{key} vs {who}")
    # the greedy tokens the steps fed (an idle slot's and a readmitted
    # slot's excepted)
    steps = reference(case, seed, True)
    sel = steps["greedy"][:-1]
    np.testing.assert_array_equal(got["logits"][:-1].argmax(-1)[sel],
                                  steps["feed"][1:][sel])
    assert bool(got["ranks_bitwise"])
