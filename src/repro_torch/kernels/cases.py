"""Seeded operands and criteria shared by `chip_smoke.py` and
`tests/test_torch_gpu.py`: the paged decode kernel's cases (held against
its plain twin and the monolithic decode kernel) and the tensor-core
route's precision criterion (forward and backward), each written once.
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
