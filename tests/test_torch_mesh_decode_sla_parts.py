"""The pieces of decode-time SLA over a mesh, in this process (no spawn):

- kernel 4's partial records (`sla_decode_partial_plain`, the twin of
  the CUDA kernel's partial mode) over 1, 2, 4 and 16 spans of one
  state, merged by `sla_decode.sla_decode_combine`, against the unsplit twin
  `sla_decode_plain`, rows with marg 0 and with a denominator <= 1e-6
  among them;
- `sla_decode.span_lut`'s re-basing and the shifted causal mask, on a span
  that holds the diagonal block and on one that holds none of the row's
  blocks;
- the placement rule for decode-SLA's 6-d h_j (`cache_shardings`: z_j's
  on the first five dims), every other leaf's spec against the
  reference's `cache_shardings` (`jax.sharding.AbstractMesh`), and the
  dry run's per-rank bytes of Qwen3-1.7B's `decode_mode="sla"` cells on
  the production (16, 16) mesh; `make_cache(decode_sla=True)` under that
  mesh at the dry run's local shapes, and the per-slot cache's on a
  (1, 2) mesh;
- the partial records of per-slot rows (a position a slot) and of a
  C = 16 chunk across block and span boundaries, combined, against the
  unsplit twin.
"""
import dataclasses
import math

import jax
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh
from torch.distributed.device_mesh import init_device_mesh

from _torch_threads import one_torch_thread  # noqa: F401
from repro.configs import get_arch as jax_get_arch
from repro.configs import get_shape as jax_get_shape
from repro.distributed import sharding as jsharding
from repro.models import registry as jregistry
from repro_torch.configs import get_arch, get_shape
from repro_torch.core.phi import phi
from repro_torch.distributed import ctx, sharding
from repro_torch.kernels import sla_decode
from repro_torch.launch import dryrun
from repro_torch.models import registry, transformer

TOL = 5e-5


def _state(seed=0, b=2, h=4, hkv=2, d=32, bkv=16, tn=16, k_sel=5, pos=250):
    """A decode state on the flat kernel layout: the live row's LUT (the
    diagonal block first) with a dead slot in one row, no live slot in
    another, marg 0 in one row and a zero linear state (den 0) in the
    last kv head's rows."""
    g = torch.Generator().manual_seed(seed)
    bh, bhk = b * h, b * hkv
    q = torch.randn((bh, 1, d), generator=g)
    k = torch.randn((bhk, tn, bkv, d), generator=g)
    v = torch.randn((bhk, tn, bkv, d), generator=g)
    hblk = torch.rand((bhk, tn, d, d), generator=g)
    zblk = torch.rand((bhk, tn, d), generator=g)
    hblk[-1], zblk[-1] = 0.0, 0.0
    row = pos // bkv
    lut = torch.stack([torch.randperm(row, generator=g)[:k_sel]
                       for _ in range(bh)]).int()
    lut[:, 0] = row
    cnt = torch.full((bh,), k_sel, dtype=torch.int32)
    cnt[1], cnt[2] = k_sel - 2, 0
    marg = torch.full((bh,), 3, dtype=torch.int32)
    marg[3] = 0
    return dict(lut=lut[:, None], cnt=cnt[:, None], marg=marg[:, None],
                posv=torch.full((bh,), pos, dtype=torch.int32), q=q,
                qp=phi(q, "softmax").float(), k=k, v=v, hblk=hblk,
                zblk=zblk, htot=hblk.sum(dim=1), ztot=zblk.sum(dim=1),
                group=h // hkv, bkv=bkv)


def _span_records(st, spans, width=None):
    """Every span's partial records, (spans, BH, 1, 2 D + 3)."""
    tn, bkv = st["k"].shape[1], st["bkv"]
    n = tn // spans
    out = []
    for r in range(spans):
        lut, cnt = sla_decode.span_lut(st["lut"], st["cnt"], r * n, n)
        cut = slice(r * n, (r + 1) * n)
        out.append(sla_decode.sla_decode_partial_plain(
            lut, cnt, st["posv"] - r * n * bkv, st["q"], st["qp"],
            st["k"][:, cut].contiguous(), st["v"][:, cut].contiguous(),
            st["hblk"][:, cut].contiguous(),
            st["zblk"][:, cut].contiguous(),
            scale=st["q"].shape[-1] ** -0.5, block_kv=bkv,
            group=st["group"], split_width=width))
    return torch.stack(out)


def _close(got, want, name):
    atol = TOL * max(1.0, float(want.abs().max()))
    torch.testing.assert_close(got, want, atol=atol, rtol=0, msg=name)


@pytest.mark.parametrize("width", [None, 1, 2])
@pytest.mark.parametrize("spans", [1, 2, 4, 16])
def test_partial_records_combine_to_the_unsplit_twin(spans, width):
    st = _state()
    d = st["q"].shape[-1]
    o_s, o_l = sla_decode.sla_decode_plain(
        st["lut"], st["cnt"], st["marg"], st["posv"], st["q"], st["qp"],
        st["k"], st["v"], st["hblk"], st["zblk"], None, None, st["htot"],
        st["ztot"], scale=d ** -0.5, block_kv=st["bkv"], group=st["group"])
    rec = _span_records(st, spans, width)
    kv = torch.arange(st["q"].shape[0]) // st["group"]
    qht = torch.einsum("bcd,bde->bce", st["qp"], st["htot"][kv])[None]
    qzt = (st["qp"] * st["ztot"][kv][:, None]).sum(dim=-1)
    got_s, got_l = sla_decode.sla_decode_combine(rec, qht, qzt, st["marg"])
    _close(got_s, o_s, "O^s")
    _close(got_l, o_l, "O^l")
    # the zero rules on the global sums: marg 0, and den <= 1e-6 (the
    # zero linear state of the last kv head's rows)
    assert (got_l[3] == 0).all() and (got_l[-st["group"]:] == 0).all()
    assert (o_l[-st["group"]:] == 0).all()
    assert (got_s[2] == 0).all()  # no live slot: an empty O^s
    again = sla_decode.sla_decode_combine(rec.clone(), qht, qzt, st["marg"])
    assert torch.equal(again[0], got_s) and torch.equal(again[1], got_l)


def test_span_lut_rebases_and_the_shifted_mask_sees_global_columns():
    """A span's records from its own blocks, its re-based LUT and the
    position shifted by its first are the records of the same slots on
    the whole state (global ids, the unshifted position): on a span that
    holds the diagonal block (columns past pos masked) and on one that
    holds none of the row's blocks (the neutral record)."""
    st = _state(k_sel=4, pos=100)  # row 6: blocks 0..6 visible
    bkv, d = st["bkv"], st["q"].shape[-1]
    lut = torch.tensor([[6, 1, 5, 0]] * st["q"].shape[0],
                       dtype=torch.int32)[:, None]
    cnt = torch.full_like(st["cnt"], 4)
    kw = dict(scale=d ** -0.5, block_kv=bkv, group=st["group"])
    for first, blocks, keep in ((4, 4, [6, 5]), (8, 8, [])):
        got_lut, got_cnt = sla_decode.span_lut(lut, cnt, first, blocks)
        assert (got_cnt == len(keep)).all()
        if keep:
            assert got_lut[0, 0, :len(keep)].tolist() == [
                j - first for j in keep]
        assert ((got_lut >= 0) & (got_lut < blocks)).all()
        cut = slice(first, first + blocks)
        got = sla_decode.sla_decode_partial_plain(
            got_lut, got_cnt, st["posv"] - first * bkv, st["q"], st["qp"],
            st["k"][:, cut].contiguous(), st["v"][:, cut].contiguous(),
            st["hblk"][:, cut].contiguous(),
            st["zblk"][:, cut].contiguous(), **kw)
        whole_lut = torch.tensor(keep + [0] * (4 - len(keep)),
                                 dtype=torch.int32).expand_as(lut[:, 0])
        want = sla_decode.sla_decode_partial_plain(
            whole_lut[:, None].contiguous(), got_cnt, st["posv"], st["q"],
            st["qp"], st["k"], st["v"], st["hblk"], st["zblk"], **kw)
        torch.testing.assert_close(got, want, atol=0, rtol=0)
        if not keep:
            assert (got[..., 0] == -1e30).all()
            assert (got[..., 1:] == 0).all()
    # the diagonal block's columns past pos are masked: only pos % bkv + 1
    # of them count (an all-ones score row shows it in l)
    ones = dict(st, q=torch.zeros_like(st["q"]))
    lut1, cnt1 = sla_decode.span_lut(lut[:, :, :1], cnt.clamp(max=1), 6, 2)
    rec = sla_decode.sla_decode_partial_plain(
        lut1, cnt1, ones["posv"] - 6 * bkv, ones["q"], ones["qp"],
        st["k"][:, 6:8].contiguous(), st["v"][:, 6:8].contiguous(),
        st["hblk"][:, 6:8].contiguous(), st["zblk"][:, 6:8].contiguous(),
        **kw)
    assert (rec[..., 1] == 100 % bkv + 1).all()


# --------------------------------------------------------------------------
# placements on fake meshes (rank 0 of a fake process group)
# --------------------------------------------------------------------------
@pytest.fixture
def fake_mesh():
    def make(shape, names=("data", "model")):
        dryrun.fake_world(math.prod(shape))
        return init_device_mesh("cpu", shape, mesh_dim_names=names)

    yield make
    if dist.is_initialized():
        dist.destroy_process_group()


def _sla_cfg(cfg):
    return dataclasses.replace(cfg, sla=cfg.sla.replace(decode_mode="sla"))


def _norm(spec, ndim):
    """A spec as one entry a dim: None where whole, an axis name, or a
    tuple of two or more."""
    out = tuple(spec) + (None,) * (ndim - len(tuple(spec)))
    return tuple(None if e is None or e == () else
                 e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in out)


@pytest.mark.parametrize("mesh_shape,batch,hkv", [
    ((2, 4), 2, 2), ((2, 4), 2, 4), ((2, 4), 1, 4), ((2, 4), 1, 2),
    ((16, 16), 128, 8), ((16, 16), 1, 8), ((16, 16), 128, 16)])
def test_hblk_is_placed_as_zblk(mesh_shape, batch, hkv, fake_mesh):
    mesh = fake_mesh(mesh_shape)
    leaves = {"sla/hblk": torch.empty((2, batch, hkv, 512, 8, 8),
                                      device="meta"),
              "sla/zblk": torch.empty((2, batch, hkv, 512, 8),
                                      device="meta")}
    got = sharding.cache_shardings(mesh, leaves, batch)
    hblk = _norm(got["sla/hblk"].spec, 6)
    assert hblk == _norm(got["sla/zblk"].spec, 5) + (None,)
    assert any(e is not None for e in hblk)


def _ref_cache_specs(arch, seq_len, batch, mesh_shape):
    """{path: (spec, shape)} of the reference's decode-SLA cache on an
    AbstractMesh (its plan's fields named as the port names them)."""
    jcfg = _sla_cfg(jax_get_arch(arch))
    if seq_len is None:
        jcfg = _sla_cfg(jax_get_arch(arch).smoke())
    shape = dataclasses.replace(jax_get_shape("decode_32k"),
                                seq_len=seq_len or 128, global_batch=batch)
    cache = jregistry.decode_specs(jcfg, shape)[1]
    jmesh = AbstractMesh(mesh_shape, ("data", "model"))
    rules = jsharding.cache_shardings(jmesh, cache, batch)
    out = {}
    for (path, leaf), (_, rule) in zip(
            jax.tree_util.tree_leaves_with_path(cache),
            jax.tree_util.tree_leaves_with_path(rules)):
        name = "/".join(str(getattr(p, "key", getattr(p, "name", "")))
                        for p in path)
        out[name] = (_norm(rule.spec, len(leaf.shape)), tuple(leaf.shape))
    return out


@pytest.mark.parametrize("arch,seq_len,batch,mesh_shape", [
    ("qwen3-1.7b", 32768, 128, (16, 16)),
    ("qwen3-1.7b", 524288, 1, (16, 16)),
    ("qwen3-1.7b", None, 2, (2, 4)),
    ("qwen3-1.7b", None, 1, (2, 4)),
    ("qwen3-1.7b", None, 2, (1, 4)),
], ids=["decode_32k", "long_500k", "smoke-2x4", "smoke-2x4-batch1",
        "smoke-1x4"])
def test_every_other_leaf_is_placed_as_the_reference_places_it(
        arch, seq_len, batch, mesh_shape, fake_mesh):
    mesh = fake_mesh(mesh_shape)
    cfg = _sla_cfg(get_arch(arch) if seq_len else get_arch(arch).smoke())
    shape = dataclasses.replace(get_shape("decode_32k"),
                                seq_len=seq_len or 128, global_batch=batch)
    cache = registry.decode_specs(cfg, shape)[1]
    got = sharding.cache_shardings(mesh, cache, batch)
    want = _ref_cache_specs(arch, seq_len, batch, mesh_shape)
    leaves = dict(sharding.tree_leaves(cache))
    assert set(leaves) == set(want)
    for path, leaf in leaves.items():
        spec, shape_ = want[path]
        assert tuple(sharding.shape_of(leaf)) == shape_, path
        mine = _norm(got[path].spec, len(shape_))
        if path == "sla/hblk":  # the 6-d rule: the reference's is P()
            assert spec == (None,) * 6
            assert mine == _norm(got["sla/zblk"].spec, 5) + (None,)
        else:
            assert mine == spec, path


# the dry run's per-rank cache bytes of Qwen3-1.7B's decode-SLA cells on
# (16, 16), h_j split as z_j is (the reference's P() would hold 896 GiB of
# it a rank at decode_32k, 112 GiB at long_500k)
SLA_CELL_BYTES = {"decode_32k": (6_027_456_968, 3_758_096_384),
                  "long_500k": (1_367_877_064, 469_762_048)}


@pytest.mark.parametrize("shape_name", list(SLA_CELL_BYTES))
def test_the_dry_runs_decode_sla_cells(shape_name, fake_mesh):
    mesh = fake_mesh((16, 16))
    cfg = _sla_cfg(get_arch("qwen3-1.7b"))
    shape = get_shape(shape_name)
    cell = dryrun.build_cell(cfg, shape, mesh)
    total, hblk = SLA_CELL_BYTES[shape_name]
    assert dryrun.rank_bytes(cell)["cache"] == total
    assert dryrun.leaf_bytes(cell["cache"]["sla/hblk"]) == hblk
    # make_cache under the mesh allocates each leaf at its local shape
    residual = ctx.default_residual_spec(mesh, shape.global_batch,
                                         shape.seq_len)
    with ctx.activation_sharding(mesh, residual):
        cache = transformer.make_cache(cfg, shape.global_batch,
                                       shape.seq_len, device="meta")
    for path, leaf in sharding.tree_leaves(cache):
        if torch.is_tensor(leaf):
            assert leaf.shape == cell["cache"][path].to_local().shape, path
    assert dryrun.rank_bytes({"cache": dict(
        sharding.tree_leaves(cache))})["cache"] == total


def test_a_split_sequence_needs_whole_blocks_a_span(fake_mesh):
    """A cache length whose spans are not whole KV blocks is refused for
    decode-time SLA (its per-block state sits beside its blocks), with
    the block named; dense decode takes it."""
    mesh = fake_mesh((1, 4))
    cfg = _sla_cfg(get_arch("qwen3-1.7b").smoke())
    with ctx.activation_sharding(mesh, ctx.default_residual_spec(mesh, 2,
                                                                 96)):
        transformer.make_cache(cfg, 2, 96, decode_sla=False, device="meta")
        with pytest.raises(ValueError, match="whole blocks of 16"):
            transformer.make_cache(cfg, 2, 96, device="meta")


def test_a_per_slot_decode_sla_cache_is_each_ranks_part(fake_mesh):
    """`make_cache(per_slot=True)` of decode-time SLA on a (1, 2) mesh:
    every leaf at its rule's local shape (K/V, h_j and z_j by heads, the
    per-slot counters (L, B), `rows` and `pos` whole on every rank), the
    rank's bytes the dry run's placement of the global cache's."""
    mesh = fake_mesh((1, 2))
    cfg = _sla_cfg(get_arch("qwen3-1.7b").smoke())
    whole = transformer.make_cache(cfg, 2, 64, per_slot=True, device="meta")
    rules = sharding.cache_shardings(mesh, whole, 2)
    cell = dryrun._place_tree(whole, rules)
    with ctx.activation_sharding(mesh, ctx.default_residual_spec(mesh, 2,
                                                                 64)):
        cache = transformer.make_cache(cfg, 2, 64, per_slot=True,
                                       device="meta")
    got, want = dict(sharding.tree_leaves(cache)), dict(
        sharding.tree_leaves(whole))
    assert got.keys() == want.keys()
    for path, leaf in got.items():
        if torch.is_tensor(leaf):
            assert tuple(leaf.shape) == rules[path].shard_shape(
                want[path].shape), path
    assert got["k"].shape[2] == cfg.num_kv_heads // 2
    for path in ("pos", "sla/rows", "sla/extends", "sla/retention"):
        assert got[path].shape == want[path].shape, path
    assert got["sla/extends"].shape == (cfg.num_layers, 2)
    assert dryrun.rank_bytes({"cache": got})["cache"] == \
        dryrun.rank_bytes({"cache": cell})["cache"]


SLOT_ROWS = {  # slot positions, tokens
    "rows": ([250, 100], 1),            # each slot's rows at its own
    "chunk": ([120, 120], 16),          # C = 16 across a span's end
    "chunk-slots": ([60, 203], 16),     # and at different positions
}


@pytest.mark.parametrize("spans", [4, 16])
@pytest.mark.parametrize("rows", list(SLOT_ROWS))
def test_partial_records_of_slot_rows_and_chunks_combine_to_the_twin(
        rows, spans):
    """Kernel 4's partial records (the twin `sla_decode_partial_plain`) of
    per-slot rows (a position a slot) and of C = 16 tokens that cross
    block and span boundaries (each token's diagonal block read from its
    partial in the span that holds it, no diagonal for a token before a
    span), combined across the spans in span order, equal the unsplit
    twin `sla_decode_plain` within 5e-5 x max(1, max |o|)."""
    from repro_torch.kernels import cases
    pos, c = SLOT_ROWS[rows]
    args, kw = cases.slot_decode_operands(5, "cpu", torch.float32, pos,
                                          hkv=2, g=2, c=c, d=32, bkv=16,
                                          tn=16, k_sel=5)
    want = sla_decode.sla_decode_plain(*args, **kw)
    n = 16 // spans
    records = torch.stack([sla_decode.sla_decode_partial_plain(
        *cases.span_operands(args, r * n, n), **kw) for r in range(spans)])
    got = cases.span_combine(records, args, kw["group"])
    _close(got[0], want[0], "O^s")
    _close(got[1], want[1], "O^l")
    assert (want[1].abs() > 0).any()


def test_each_step_reads_its_placements_from_the_mesh_it_runs_on(
        fake_mesh, monkeypatch):
    """Two 1 x 1 meshes, one after the other in one process, each over a
    new process group: every decode-SLA call builds its `SLAParts` from
    the mesh it runs under (none is kept from an earlier group, whose
    sub-groups are gone), and both runs equal the plain path bitwise over
    20 steps that cross the block boundaries at 64 and 80."""
    import numpy as np

    from repro_torch.distributed import serving
    from repro_torch.models import common

    cfg = _sla_cfg(get_arch("qwen3-1.7b").smoke())
    torch.manual_seed(0)
    model = transformer.init(None, cfg, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, size=(2, 64)).astype(np.int32))
    seen = []

    class Recorded(serving.SLAParts):
        def __init__(self, kl, *args):
            super().__init__(kl, *args)
            seen.append(self.mesh)

    monkeypatch.setattr(serving, "SLAParts", Recorded)

    def run():
        with torch.no_grad():
            hidden, cache = transformer.prefill(
                model, cfg, tokens, torch.float32, "kernel",
                decode_max_len=128)
            logits = [common.logits_from_hidden(model, hidden)]
            for _ in range(20):
                lg, cache = transformer.decode_step(
                    model, cfg, logits[-1].argmax(-1).int(), cache,
                    torch.float32, backend="kernel")
                logits.append(lg)
        return torch.stack(logits), dict(sharding.tree_leaves(cache))

    want, want_leaves = run()
    assert seen and all(m is None for m in seen)
    for _ in range(2):
        if dist.is_initialized():
            dist.destroy_process_group()
        mesh = fake_mesh((1, 1))
        seen.clear()
        with ctx.activation_sharding(
                mesh, ctx.default_residual_spec(mesh, 2, 128)):
            got, got_leaves = run()
        assert len(seen) >= 21 and all(m is mesh for m in seen)
        assert torch.equal(got, want)
        assert got_leaves.keys() == want_leaves.keys()
        for path, leaf in want_leaves.items():
            if torch.is_tensor(leaf):
                assert torch.equal(got_leaves[path], leaf), path
            else:
                assert got_leaves[path] == leaf, path
