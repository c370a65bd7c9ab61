"""Paged caches and chunked admission over a ("data", "model") mesh: the
cases of tests/test_torch_mesh_paged.py as one process runs them, on one
device (the test's own process) or as one gloo rank
(`tests/_torch_mesh_worker.py::case_paged`). Imports torch and the port
only.

`run_case(case, model, cfg, inputs, mesh)` runs a case on one device
(`mesh` None) or over `mesh` and returns its records, {key: numpy
array}. `run_cases` is the worker's side: each case on its own mesh over
the world, its records gathered to rank 0, each rank's part of a cache
assembled into global leaves by the rules of the cache it stands for.

Kinds of case:
  paged    a paged cache (`make_paged_cache`) of `batch` slots and
           `pool` pages: batch-1 prefills admitted with
           `insert_slot_paged` at the steps and pages of `admit`
           ([step, slot, prompt, pages, hit]; a page named twice is a
           shared prefix page, rewritten by the later admission; with
           `hit` the pages already hold the prompt and the admission is
           `insert_slot_state_paged` of `slot_state_from_prefill`, the
           full-prompt hit), the rest of
           the slot's page-table row the zero page; an idle slot's row
           its scratch page (`scratch`); `cow` ([step, slot, block,
           page]) copies the slot's page at `block` to `page`
           (`copy_page`) and points the row there; before each step an
           active slot entering a block gets a fresh page (the next id
           from `fresh`, zeroed by `copy_page(new, 0)`), and the table is
           pushed (`set_page_table`). `steps` `decode_step`s, each of a
           row of `feed` (`_Tokens`: without `feed` the run's own greedy
           tokens, recorded as "feed", "greedy" and "chosen"). Beside
           it, over the same mesh, the per-slot cache the paged one
           stands for
           (`make_cache(per_slot=True)`, `insert_slot`) takes the same
           admissions and tokens. Records: "logits" (steps, B, V)
           gathered over the data ranks, "prefill<i>", under "view/"
           the rank's `paged_dense_view` at the end, "view_bitwise"
           whether it equals the rank's per-slot part bit for bit, and
           with `refuse` whether `set_page_table` refused a table
           naming a page of another data rank's pool, and one whose page
           an admission of another data rank rewrote under a live slot;
           "paged_partial_calls" the calls of kernel 5's partial mode
           (its plain twin on these CPU tensors) on this rank;
           "restore_bitwise" whether, at step `snap_at`,
           `snapshot_slots` of every slot, a `decode_step` and
           `restore_slots` left the paged cache's view and the per-slot
           cache bit for bit as they were;
  chunked  `make_prefill_carry`, `prefill_chunk` over the prompt's
           `chunks` ([start, length]), `finalize_chunked_prefill`, then
           `steps` `decode_step`s of `feed` (or its own tokens, as
           for paged); beside it the blocking
           `prefill(decode_max_len=)`. Records: "chunk<i>" each chunk's
           last-row logits, "prefill0" the blocking prefill's, "logits"
           (steps, 1, V), under "final/" the finalized cache (the rank's
           part), "blocking_ints" whether its integer leaves and `pos`
           equal the blocking prefill's bit for bit, "blocking_err" the
           largest float difference from it (over max(1, |blocking|)),
           and "carry_bytes" the rank's carry.
A prefill runs under the batch-1 scope (`default_residual_spec(mesh, 1,
cache_len)`), a chunk under the bucket's, everything else under the
batch's.
"""
import numpy as np
import torch

from _torch_mesh_slots import _np, _scope, case_cfg, case_model
from repro_torch.distributed import ctx, sharding
from repro_torch.kernels import sla_decode
from repro_torch.models import common, transformer


def _leaves(tree) -> dict:
    return {p: leaf for p, leaf in sharding.tree_leaves(tree)
            if torch.is_tensor(leaf)}


def global_view(cfg, case: dict) -> dict:
    """{path: meta tensor} of the per-slot cache a paged case's cache
    stands for (or, for a chunked case, of the batch-1 static cache), at
    its global shapes: the rules' input."""
    cache = transformer.make_cache(
        cfg, case["batch"], case["cache_len"], dtype=torch.float32,
        decode_sla=cfg.sla.decode_mode == "sla",
        per_slot=case["kind"] == "paged", device="meta")
    return _leaves(cache)


def _prefill(case, model, cfg, prompt, mesh):
    length = case["cache_len"]
    sla = cfg.sla.decode_mode == "sla"
    kw = {"decode_max_len": length} if sla else {"cache_len": length}
    with _scope(mesh, 1, length):
        hidden, single = transformer.prefill(
            model, cfg, torch.from_numpy(prompt), torch.float32, "kernel",
            **kw)
        return common.logits_from_hidden(model, hidden), single


class _Tokens:
    """The tokens a run feeds: `inputs["feed"]` (steps, B) where given,
    else its own greedy ones (a slot's first token its prompt's argmax,
    then its step logits' argmax while it is active, 0 while idle), with
    the records "feed", "greedy" (which step logits chose the next step's
    token) and "chosen" (every logits row that chose a fed token)."""

    def __init__(self, inputs, steps: int, b: int):
        self.feed = inputs.get("feed")
        self.tok = np.zeros(b, np.int32)
        self.fed, self.chosen = [], []
        self.greedy = np.zeros((steps, b), bool)

    def admitted(self, i: int, slot: int, logits: np.ndarray) -> None:
        row = logits[0]
        self.tok[slot] = row.argmax()
        self.chosen.append(row)
        if i:
            self.greedy[i - 1, slot] = False

    def step(self, i: int) -> np.ndarray:
        self.fed.append(self.tok.copy() if self.feed is None
                        else self.feed[i])
        return self.fed[-1]

    def stepped(self, i: int, logits: np.ndarray, active) -> None:
        self.greedy[i] = [s in active for s in range(len(self.tok))]
        self.tok = np.where(self.greedy[i], logits.argmax(-1),
                            0).astype(np.int32)

    def records(self, rec: dict) -> None:
        if self.feed is not None:
            return
        self.greedy[-1] = False  # the last logits choose no fed token
        rec["feed"] = np.stack(self.fed).astype(np.int32)
        rec["greedy"] = self.greedy
        rec["chosen"] = np.concatenate([np.stack(self.chosen),
                                        rec["logits"][self.greedy]])


def _paged(case, model, cfg, inputs, mesh, rec):
    calls = [0]
    twin = sla_decode.sla_decode_paged_partial_plain

    def counted(*args, **kw):
        calls[0] += 1
        return twin(*args, **kw)

    sla_decode.sla_decode_paged_partial_plain = counted
    try:
        _paged_run(case, model, cfg, inputs, mesh, rec)
    finally:
        sla_decode.sla_decode_paged_partial_plain = twin
    rec["paged_partial_calls"] = np.array(calls[0])


def _paged_run(case, model, cfg, inputs, mesh, rec):
    b, length = case["batch"], case["cache_len"]
    bkv = cfg.sla.block_kv
    tn = length // bkv
    with _scope(mesh, b, length):
        paged = transformer.make_paged_cache(
            cfg, b, length, case["pool"], dtype=torch.float32, device="cpu")
        slots = transformer.make_cache(cfg, b, length, dtype=torch.float32,
                                       per_slot=True, device="cpu")
    pt = np.zeros((b, tn), np.int32)
    for slot in range(b):
        pt[slot] = case["scratch"][slot]
    fresh = case["fresh"]
    active = set()
    logits = []
    toks = _Tokens(inputs, case["steps"], b)
    for i in range(case["steps"]):
        for at, slot, k, pages, hit in case["admit"]:
            if at != i:
                continue
            lg, single = _prefill(case, model, cfg, inputs[f"prompt{k}"],
                                  mesh)
            rec[f"prefill{k}"] = _np(lg)
            toks.admitted(i, slot, rec[f"prefill{k}"])
            with _scope(mesh, b, length):
                if hit:  # its pages hold the prompt: the state alone
                    transformer.insert_slot_state_paged(
                        paged, transformer.slot_state_from_prefill(single),
                        slot, cfg)
                else:
                    transformer.insert_slot_paged(paged, single, slot,
                                                  pages, cfg)
                transformer.insert_slot(slots, single, slot, cfg)
            del single
            pt[slot] = 0
            pt[slot, :len(pages)] = pages
            active.add(slot)
        for at, slot, blk, page in case["cow"]:
            if at == i:
                transformer.copy_page(paged, page, int(pt[slot, blk]))
                pt[slot, blk] = page
        for slot in sorted(active):
            p = int(paged["pos_host"][slot])
            if p % bkv == 0 and p // bkv < tn:
                transformer.copy_page(paged, fresh, 0)
                pt[slot, p // bkv] = fresh
                fresh += 1
        with _scope(mesh, b, length):
            transformer.set_page_table(paged, pt)
        tok = toks.step(i)
        if i == case["snap_at"]:
            rec["restore_bitwise"] = np.array(all(
                _step_undone(model, cfg, tok, cache, mesh, b, length)
                for cache in (paged, slots)))
        with _scope(mesh, b, length):
            lg, paged = transformer.decode_step(
                model, cfg, torch.from_numpy(tok), paged, torch.float32,
                backend="kernel")
            transformer.decode_step(model, cfg, torch.from_numpy(tok), slots,
                                    torch.float32, backend="kernel")
            logits.append(_np(ctx.gather_batch(lg)))
        toks.stepped(i, logits[-1], active)
    rec["logits"] = np.stack(logits)
    toks.records(rec)
    with _scope(mesh, b, length):
        view = _leaves(transformer.paged_dense_view(cfg, paged))
    part = _leaves(slots)
    rec["view_bitwise"] = np.array(set(view) == set(part) and all(
        torch.equal(view[p], part[p]) for p in view))
    for path, leaf in view.items():
        rec[f"view/{path}"] = _np(leaf).copy()
    if case.get("refuse") and mesh is not None:
        rec["refused"] = np.array(_refused(case, model, cfg, inputs, mesh,
                                           paged, pt))


def _step_undone(model, cfg, tok, cache, mesh, b, length) -> bool:
    """Whether `snapshot_slots` of every slot, a `decode_step` and
    `restore_slots` leave `cache` (its paged dense view, for a paged
    cache) bit for bit as it was."""
    def leaves():
        view = (transformer.paged_dense_view(cfg, cache) if "kp" in cache
                else cache)
        return {p: t.clone() for p, t in _leaves(view).items()}

    with _scope(mesh, b, length):
        before = leaves()
        snap = transformer.snapshot_slots(cache, range(b), cfg)
        transformer.decode_step(model, cfg, torch.from_numpy(tok), cache,
                                torch.float32, backend="kernel")
        transformer.restore_slots(cache, snap)
        after = leaves()
    return set(before) == set(after) and all(
        torch.equal(before[p], after[p]) for p in before)


def _refused(case, model, cfg, inputs, mesh, paged, pt) -> list:
    """[named refused, shared refused]: `set_page_table` of a table in
    which a slot of the last data rank names a page the first data rank's
    slot 0 wrote (its row's first page), and of the case's own table once
    `insert_slot_paged` has written that page for the last data rank's
    slot while slot 0 still names it (prefix sharing across data
    ranks)."""
    b, length = case["batch"], case["cache_len"]
    page, other = int(pt[0, 0]), b - 1
    bad = pt.copy()
    bad[other, 0] = page
    out = []
    _, single = _prefill(case, model, cfg, inputs["prompt0"], mesh)
    with _scope(mesh, b, length):
        for table in (bad, pt):
            if table is pt:
                transformer.insert_slot_paged(paged, single, other, [page],
                                              cfg)
            try:
                transformer.set_page_table(paged, table)
                out.append(False)
            except ValueError:
                out.append(True)
    return out


def _chunked(case, model, cfg, inputs, mesh, rec):
    length = case["cache_len"]
    prompt = torch.from_numpy(inputs["prompt0"])
    bucket = prompt.shape[1]
    lg, blocking = _prefill(case, model, cfg, inputs["prompt0"], mesh)
    rec["prefill0"] = _np(lg)
    with _scope(mesh, 1, bucket):
        carry = transformer.make_prefill_carry(
            cfg, bucket, torch.float32, decode_sla=True, device="cpu")
        rec["carry_bytes"] = np.array(sum(
            t.numel() * t.element_size() for t in carry.values()))
        for i, (start, n) in enumerate(case["chunks"]):
            carry, hidden = transformer.prefill_chunk(
                model, cfg, prompt[:, start:start + n], carry, start,
                torch.float32, "kernel", decode_max_len=length)
            rec[f"chunk{i}"] = _np(common.logits_from_hidden(model, hidden))
    with _scope(mesh, 1, length):
        cache = transformer.finalize_chunked_prefill(cfg, carry, length)
    got, want = _leaves(cache), _leaves(blocking)
    ints = set(got) == set(want) and cache["pos"] == blocking["pos"]
    err = 0.0
    for path, leaf in got.items():
        if leaf.is_floating_point():
            w = want[path].float()
            err = max(err, float((leaf.float() - w).abs().max())
                      / max(1.0, float(w.abs().max())))
        else:
            ints = ints and torch.equal(leaf, want[path])
    rec["blocking_ints"] = np.array(ints)
    rec["blocking_err"] = np.array(err)
    for path, leaf in got.items():
        rec[f"final/{path}"] = _np(leaf).copy()
    rec["final/pos"] = np.asarray(cache["pos"])
    rec["final/sla/rows"] = np.asarray(cache["sla"]["rows"])
    logits = []
    toks = _Tokens(inputs, case["steps"], 1)
    toks.admitted(0, 0, rec[f"chunk{len(case['chunks']) - 1}"])
    with _scope(mesh, 1, length):
        for i in range(case["steps"]):
            lg, cache = transformer.decode_step(
                model, cfg, torch.from_numpy(toks.step(i)), cache,
                torch.float32, backend="kernel")
            logits.append(_np(lg))
            toks.stepped(i, logits[-1], {0})
    rec["logits"] = np.stack(logits)
    toks.records(rec)
    return cache


KINDS = {"paged": _paged, "chunked": _chunked}


def run_case(case: dict, model, cfg, inputs: dict, mesh=None) -> dict:
    """The case's records (module docstring)."""
    rec = {}
    with torch.no_grad():
        KINDS[case["kind"]](case, model, cfg, inputs, mesh, rec)
    return rec


def run_cases(spec: dict, out: dict) -> None:
    """The worker's side: every case of `spec["cases"]` on its own mesh
    over this world (the weights placed by the rules). Rank 0 writes each
    global record once (and whether every rank held its bits), each
    "view/" or "final/" leaf assembled from every rank's part by the
    rule's spec of the cache it stands for (and whether the ranks that
    hold the same shard hold the same bits); "view_bitwise",
    "restore_bitwise" and "blocking_ints" as every rank's AND,
    "blocking_err" as their max, "carry_bytes" and "paged_partial_calls"
    as every rank's."""
    import torch.distributed as dist

    from _torch_mesh_worker import _assemble, _every_rank, _replicas
    from repro_torch.launch import mesh as mesh_lib
    for case in spec["cases"]:
        name = case["name"]
        cfg = case_cfg(case)
        model = case_model(case, cfg)
        mesh = mesh_lib.make_host_mesh(*case["mesh"], "cpu")
        sizes = sharding.axis_sizes(mesh)
        coords = {a: mesh.get_local_rank(a) for a in mesh.mesh_dim_names}
        sharding.place_module(model, mesh)
        data = np.load(case["inputs"])
        inputs = {k: data[k] for k in data.files}
        rec = run_case(case, model, cfg, inputs, mesh)
        batch = case["batch"] if case["kind"] == "paged" else 1
        specs = sharding.cache_shardings(
            mesh, global_view(cfg, dict(case, batch=batch)), batch)
        ranks = _every_rank((coords, rec))
        dist.barrier()
        if dist.get_rank():
            continue
        same = True
        for key, val in rec.items():
            path = key.partition("/")[2]
            if key.startswith(("view/", "final/")) and path in specs:
                parts = [(c, other[key]) for c, other in ranks]
                ok, _ = _replicas(parts, specs[path].spec)
                same = same and ok
                out[f"{name}/{key}"] = _assemble(parts, specs[path].spec,
                                                 sizes)
                continue
            every = [other[key] for _, other in ranks]
            if key in ("view_bitwise", "blocking_ints", "restore_bitwise"):
                val = np.array(all(bool(v) for v in every))
            elif key == "blocking_err":
                val = np.array(max(float(v) for v in every))
            elif key in ("carry_bytes", "paged_partial_calls"):
                val = np.array([int(v) for v in every])
            else:
                same = same and all(np.array_equal(v, val) for v in every)
            out[f"{name}/{key}"] = val
        out[f"{name}/ranks_bitwise"] = np.array(same)
