"""Seeded operands for holding the paged decode kernel against its plain
twin and against the monolithic decode kernel on the card.

`chip_smoke.py` and `tests/test_torch_gpu.py` both build their cases
here, so the pool layout a case assumes is written once.
"""
from __future__ import annotations

import torch

from repro_torch.core.backends import gather_pages


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
