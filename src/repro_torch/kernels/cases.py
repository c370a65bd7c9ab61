"""Seeded operands and criteria shared by `chip_smoke.py` and
`tests/test_torch_gpu.py`: the paged decode kernel's cases (held against
its plain twin and the monolithic decode kernel), the decode kernel's
partial mode over the spans of a split cache (`span_operands`,
`span_combine`, `record_error`) on the rows continuous batching and
verify-style decode give it (`slot_decode_operands`), the paged kernel's
partial mode over the spans of a split paged cache
(`paged_span_operands`), and the
tensor-core route's precision
criterion (forward and backward), each written once.
"""
from __future__ import annotations

import torch

from repro_torch.core.backends import gather_pages

# The tensor-core route against the f32 twin (FlashAttention's precision:
# P rounded to bf16 before P V in the forward; dO, P and dS before their
# products in the backward).
TC_ROUNDING_FACTOR = 2.0   # times the rounded twin's own distance
TC_SUM_TOL = 5e-5          # plus summation order, x max(1, max |twin|)
TC_CONFORMANCE_TOL = 5e-2  # and never past the repo's bf16 conformance


def tc_criterion(got, want, rounded) -> dict:
    """Hold a tensor-core result of either route against the f32 twin:
    with err(x) = max |x - want| over every output and m = max(1, max
    |want|), pass when err(got) <= 2 err(rounded) + 5e-5 m and err(got) <=
    5e-2 m. `got`, `want` and `rounded` (the twin with
    `mma_dtype=torch.bfloat16`) are a tensor or a tuple of tensors in one
    order: dQ, or (dK, dV), for the backward; (O^s, lse) for the forward,
    whose O^l (f32 arithmetic on both routes) is held to 5e-5 apart. The
    kernel's distance from the f32 twin is then bf16 rounding, not
    summation order."""
    got, want, rounded = ((x,) if torch.is_tensor(x) else tuple(x)
                          for x in (got, want, rounded))
    err = max(float((g.float() - w).abs().max()) for g, w in zip(got, want))
    r_err = max(float((r - w).abs().max()) for r, w in zip(rounded, want))
    m = max(1.0, max(float(w.abs().max()) for w in want))
    limit = min(TC_ROUNDING_FACTOR * r_err + TC_SUM_TOL * m,
                TC_CONFORMANCE_TOL * m)
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    return dict(max_abs_err=err, rounded_err=r_err, limit=limit,
                ok=finite and err <= limit)


def paged_decode_operands(seed: int, kv_dtype, pos: int, *, b: int,
                          hkv: int, g: int, d: int, bkv: int, tn: int,
                          npages: int, k_sel: int, shared: int,
                          runaway: bool = False, device="cuda"):
    """`sla_decode_paged`'s operands and keywords: page pools of `npages`
    pages (page 0 the zero page), a page table in which the b slots share
    their first `shared` pages and hold distinct shuffled pages after
    them, a live row per slot at `pos` (mid-block, past the shared
    pages), a LUT per q head with the diagonal block first and distinct
    earlier blocks after it, cnt in [1, K], every third marg 0, padded
    LUT slots naming later blocks whose pages hold NaN, and each slot's
    running totals over its live blocks. `runaway`: the last slot sits
    past max_len (its row clamps to the last block) with an out-of-range
    logical id in its LUT."""
    gen = torch.Generator(device=device).manual_seed(seed)
    h = hkv * g
    bh = b * h

    def rnd(*shape):
        return torch.rand(shape, generator=gen, device=device)

    k = torch.randn((npages, hkv, bkv, d), generator=gen, device=device)
    v = torch.randn((npages, hkv, bkv, d), generator=gen, device=device)
    hblk, zblk = rnd(npages, hkv, d, d) * 0.2, rnd(npages, hkv, d) + 0.1
    perm = torch.randperm(npages - 1, generator=gen, device=device) + 1
    if shared + b * (tn - shared) > npages - 1:
        raise ValueError(f"{npages} pages cannot hold {b} slots of {tn} "
                         f"blocks sharing {shared}")
    pt = torch.empty((b, tn), dtype=torch.int32, device=device)
    pt[:, :shared] = perm[:shared].int()
    pt[:, shared:] = perm[shared:shared + b * (tn - shared)].reshape(
        b, tn - shared).int()
    poss = [pos] * b
    if runaway:
        poss[-1] = tn * bkv + 5
    row = pos // bkv
    if not shared <= row < tn - 1:
        raise ValueError(f"pos {pos} must lie past the shared pages and "
                         f"before the last block")
    for bi in range(b - int(runaway)):
        dead = pt[bi, row + 1:].long()
        for t in (k, v, hblk, zblk):
            t[dead] = float("nan")
    lut = torch.empty((bh, 1, k_sel), dtype=torch.int32, device=device)
    for r in range(bh):
        slot_row = min(poss[r // h] // bkv, tn - 1)
        others = torch.randperm(slot_row, generator=gen, device=device)
        lut[r, 0] = torch.cat([torch.tensor([slot_row], device=device),
                               others[:k_sel - 1]]).int()
    cnt = torch.randint(1, k_sel + 1, (bh, 1), generator=gen,
                        device=device).int()
    dead = torch.arange(k_sel, device=device) >= cnt[..., None]
    later = torch.randint(row + 1, tn, (bh, 1, k_sel), generator=gen,
                          device=device).int()
    lut = torch.where(dead, later, lut)
    if runaway:
        lut[-h:, 0, 0] = tn + 2  # clamps to the last block
    lut = lut.contiguous()
    marg = torch.randint(1, 4, (bh, 1), generator=gen, device=device).int()
    marg.view(-1)[::3] = 0
    ptl = pt.long()
    live_pages = [ptl[bi, :min(poss[bi] // bkv, tn - 1) + 1]
                  for bi in range(b)]
    htot = torch.cat([torch.nan_to_num(hblk[p]).sum(0) for p in live_pages])
    ztot = torch.cat([torch.nan_to_num(zblk[p]).sum(0) for p in live_pages])
    q = torch.randn((bh, 1, d), generator=gen, device=device)
    qp = torch.softmax(torch.randn((bh, 1, d), generator=gen,
                                   device=device), dim=-1)
    posv = torch.tensor(poss, dtype=torch.int32,
                        device=device).repeat_interleave(h)
    args = (lut, pt, cnt, marg, posv, q, qp, k.to(kv_dtype), v.to(kv_dtype),
            hblk, zblk, htot.contiguous(), ztot.contiguous())
    return args, dict(scale=d ** -0.5, block_kv=bkv, group=g)


def paged_dense_operands(args):
    """`sla_decode`'s operands on the page-gathered (monolithic) view of
    the same pools, from `sla_decode_paged`'s: one layer of what
    `transformer.paged_dense_view` holds, flattened to (B * Hkv, Tn, ...)."""
    lut, pt, cnt, marg, posv, q, qp, k, v, hblk, zblk, htot, ztot = args

    def view(pool):  # (P, Hkv, ...) -> (B * Hkv, Tn, ...)
        return gather_pages(pool, pt).flatten(0, 1).contiguous()

    return (lut, cnt, marg, posv, q, qp, view(k), view(v), view(hblk),
            view(zblk), None, None, htot, ztot)


def slot_decode_operands(seed: int, device, kv_dtype, pos, *, hkv: int,
                         g: int, c: int, d: int, bkv: int, tn: int,
                         k_sel: int):
    """Kernel 4's flat operands (`sla_decode`'s, lut .. ztot) for the
    decode rows continuous batching and verify-style decode give it: slot
    b's rows at its own position pos[b] (a different one each slot), C
    tokens from there (token c at pos[b] + c, crossing block boundaries
    as they come), each token's LUT its own diagonal block first and other
    distinct earlier blocks after it, cnt in [1, K], every third marg 0;
    the h_j, z_j of blocks no token has reached zero; at C > 1 per-token
    totals and diagonal partials that grow token by token, at C = 1 one
    running total per kv head and no partials. Returns (args, kw)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    b = len(pos)
    bh, bh_kv = b * hkv * g, b * hkv

    def rnd(*shape):
        return torch.rand(shape, generator=gen, device=device)

    posv = torch.tensor(pos, dtype=torch.int32, device=device) \
        .repeat_interleave(hkv * g)
    row = (posv[:, None].long() + torch.arange(c, device=device)) // bkv
    k = torch.randn((bh_kv, tn, bkv, d), generator=gen, device=device)
    v = torch.randn((bh_kv, tn, bkv, d), generator=gen, device=device)
    hblk, zblk = rnd(bh_kv, tn, d, d) * 0.2, rnd(bh_kv, tn, d) + 0.1
    top = row.reshape(b, -1).amax(dim=1).repeat_interleave(hkv)
    reached = torch.arange(tn, device=device) <= top[:, None]
    hblk = hblk * reached[..., None, None]
    zblk = zblk * reached[..., None]
    # other blocks: the blocks before the diagonal in a random order
    blocks = torch.arange(tn, device=device)
    before = blocks < row[..., None]
    others = torch.argsort(torch.where(before, rnd(bh, c, tn), -1.0),
                           dim=-1, descending=True)[..., :k_sel - 1]
    others = torch.where(torch.gather(before, -1, others), others,
                         row[..., None])
    lut = torch.cat([row[..., None], others], dim=-1)
    cnt = torch.minimum(torch.randint(1, k_sel + 1, (bh, c), generator=gen,
                                      device=device), row + 1)
    dead = torch.arange(k_sel, device=device) >= cnt[..., None]
    lut = torch.where(dead, row[..., None], lut).int().contiguous()
    cnt = cnt.int().contiguous()
    marg = torch.randint(0, 4, (bh, c), generator=gen, device=device).int()
    marg.view(-1)[::3] = 0
    grow, growz = rnd(bh_kv, c, d, d) * 0.05, rnd(bh_kv, c, d) * 0.05
    htot = (hblk.sum(1)[:, None] + grow.cumsum(1)).contiguous()
    ztot = (zblk.sum(1)[:, None] + growz.cumsum(1)).contiguous()
    if c == 1:
        hdiag = zdiag = None
        htot, ztot = htot[:, 0], ztot[:, 0]
    else:
        kv_row = row[::g]  # (BH_kv, C): each kv row's tokens' blocks
        at = torch.arange(bh_kv, device=device)[:, None]
        hdiag = (hblk[at, kv_row] * 0.5 + grow.cumsum(1)).contiguous()
        zdiag = (zblk[at, kv_row] * 0.5 + growz.cumsum(1)).contiguous()
    q = torch.randn((bh, c, d), generator=gen, device=device)
    qp = torch.softmax(torch.randn((bh, c, d), generator=gen,
                                   device=device), dim=-1)
    args = (lut, cnt, marg, posv.contiguous(), q, qp, k.to(kv_dtype),
            v.to(kv_dtype), hblk.contiguous(), zblk.contiguous(), hdiag,
            zdiag, htot, ztot)
    return args, dict(scale=d ** -0.5, block_kv=bkv, group=g)


def span_operands(args, first: int, blocks: int):
    """`sla_decode_partial`'s operands for the span of `blocks` KV blocks
    from block `first`, from `sla_decode`'s operands `args` (lut, cnt,
    marg, posv, q, qp, k, v, hblk, zblk, hdiag, zdiag, htot, ztot): the
    LUT's slots in the span re-based to its ids (`sla_decode.span_lut`),
    the positions shifted by its first, the span's own copy of its K/V,
    h_j and z_j blocks (a rank's leaves), and the tokens' diagonal
    partials (None at C = 1)."""
    from repro_torch.kernels import sla_decode
    lut, cnt, _, posv, q, qp, k, v, hblk, zblk, hdiag, zdiag = args[:12]
    span_lut, span_cnt = sla_decode.span_lut(lut, cnt, first, blocks)
    cut = slice(first, first + blocks)
    return (span_lut, span_cnt, (posv - first * k.shape[2]).int(), q, qp,
            k[:, cut].contiguous(), v[:, cut].contiguous(),
            hblk[:, cut].contiguous(), zblk[:, cut].contiguous(), hdiag,
            zdiag)


def paged_span_operands(args, first: int, blocks: int):
    """Kernel 5's partial mode over the span of `blocks` logical blocks
    from block `first`, from `sla_decode_paged`'s operands `args`: returns
    (paged, dense), `sla_decode_paged_partial`'s operands (the span's
    re-based LUT, the span's columns of the page table, the positions
    shifted by its first, the pools as they are) and
    `sla_decode_partial`'s on the page-gathered view of the same span
    (`span_operands` of `paged_dense_operands`), whose records the paged
    ones equal bitwise."""
    from repro_torch.kernels import sla_decode
    lut, pt, cnt, _, posv, q, qp, k, v, hblk, zblk = args[:11]
    span_lut, span_cnt = sla_decode.span_lut(lut, cnt, first, blocks)
    paged = (span_lut, pt[:, first:first + blocks].contiguous(), span_cnt,
             (posv - first * k.shape[2]).int(), q, qp, k, v, hblk, zblk)
    dense = span_operands(paged_dense_operands(args), first, blocks)[:9]
    return paged, dense


def span_combine(records, args, group: int):
    """`sla_decode.sla_decode_combine` of the spans' records (spans, BH, C,
    2 D + 3) with phi(q) Htot and phi(q) Ztot from `args`' totals (one
    running total per kv head, or one per token; one part: Htot whole)
    and its marg. Returns (o_s, o_l)."""
    from repro_torch.kernels import sla_decode
    marg, qp, htot, ztot = args[2], args[5], args[12], args[13]
    kv = torch.arange(qp.shape[0], device=qp.device) // group
    ht, zt = htot[kv], ztot[kv]
    if ht.ndim == 3:  # one running total: every token's
        ht, zt = ht[:, None], zt[:, None]
    qht = torch.einsum("bcd,bcde->bce", qp, ht.expand(
        -1, qp.shape[1], -1, -1))[None]
    qzt = (qp * zt).sum(dim=-1)
    return sla_decode.sla_decode_combine(records, qht, qzt, marg)


def record_error(got, want) -> dict:
    """A partial record (..., 2 D + 3) against its twin, field by field:
    the max over m (where the twin's row walked a column; bitwise -1e30
    where it walked none), l, acc, hsel and zsel of |got - want| / max(1,
    max |want| of that field). Returns {"err": that max, "neutral_ok":
    the unwalked rows' m bitwise}."""
    d = (want.shape[-1] - 3) // 2
    walked = want[..., 0] > -1e29
    fields = {"m": (got[..., 0][walked], want[..., 0][walked]),
              "l": (got[..., 1], want[..., 1]),
              "acc": (got[..., 2:2 + d], want[..., 2:2 + d]),
              "hsel": (got[..., 2 + d:2 + 2 * d], want[..., 2 + d:2 + 2 * d]),
              "zsel": (got[..., 2 + 2 * d], want[..., 2 + 2 * d])}
    err = 0.0
    for g, w in fields.values():
        if w.numel():
            err = max(err, float((g - w).abs().max())
                      / max(1.0, float(w.abs().max())))
    return dict(err=err, neutral_ok=bool(torch.equal(
        got[..., 0][~walked], want[..., 0][~walked])))
