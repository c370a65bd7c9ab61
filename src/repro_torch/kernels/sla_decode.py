"""Fused SLA decode: the CUDA kernels of `csrc/sla_decode.cu`, their plain
twins, their launch counters, and the public `decode_attention` entry.

Counterpart of the Pallas TPU kernels `repro.kernels.sla_decode._decode_kernel`
(via `_fused_decode`) and `_decode_kernel_paged` (via `_fused_decode_paged`
and `_decode_attention_paged`), and of `decode_attention`. One launch covers a chunk
of C decode tokens (C = 1 is a plain `decode_step`): for each (batch*head,
token c) at position pos + c it runs online softmax over the live row's
critical KV blocks (columns <= pos + c) and the subtractive linear branch

    O^l = phi(q) (htot - sum_{j in lut} hblk[j]) / phi(q) (ztot - ...)

where the in-flight diagonal block reads the per-token partials
hdiag/zdiag when the state holds them (live-row decode has none: there the
partial is the stored block); O^l is zero where marg = 0 or the
denominator is <= 1e-6.

On the card the LUT walk is split (flash-decoding): a split kernel whose
blocks each walk `split_width` slots of a row and write a partial record
into an f32 workspace, then a combine kernel that merges a row's records
in split order (deterministic: two launches are bitwise equal). Head dims
run up to `MAX_HEAD_DIM` (256): above 128 each lane owns 8 columns and
the H tiles stream through the block's stage in row slices. The
width is `choose_split_width(rows, K, SMs)`, a function of the shapes and the
card only, so a paged call and a monolithic call on the same rows split
alike; a caller may force one (1 <= width <= K).

`sla_decode` launches the kernels for CUDA tensors and runs
`sla_decode_plain` (plain PyTorch gathers, the twin of the reference's
`_decode_math`) only for CPU tensors. `LAUNCHES` counts calls that
launched the kernels, one per call (split and combine together), and
nothing else. `decode_attention` is differentiable through a
`torch.autograd.Function` whose backward is autograd over the plain twin,
as the reference's `custom_vjp` is JAX autodiff over `_decode_math`.
The twins take `split_width` too: they then compute the kernel's partial
records and combine them in its order (tests only).

Over a cache whose sequence is split across ranks (a (data, model) mesh,
`distributed/serving.py`) each rank runs `sla_decode_partial` on its own
span: the same split kernel without the totals' block, and the combine
kernel's partial mode, which writes the merged record before any divide,
(m, l, acc[D], hsel[D], zsel) per row; a row at its own position (each
slot's), and C tokens a row with their diagonal partials (a chunk that
crosses blocks and spans). `span_lut` re-bases the live row's blocks to
a span's ids, and `sla_decode_combine` merges the spans' records in span
order and finishes both branches on the global sums.
`PARTIAL_LAUNCHES` and `PARTIAL_HEAD_DIMS` count the partial mode's calls
apart; its twin is `sla_decode_partial_plain`.

Paged decode state (a page table `"pt"` (B, Tn) and the layer's page
pools in place of the per-slot leaves) goes to `sla_decode_paged`: the
same kernel body with K/V/hblk/zblk read from the pools at page
pt[b, lut] (masking on the logical ids), single-token only, counted by
`PAGED_LAUNCHES` apart from `LAUNCHES` (one per call as well); its twin
is `sla_decode_paged_plain`. Serving never differentiates it.
`HEAD_DIMS` and `PAGED_HEAD_DIMS` count the same calls by the head dim
the kernels ran at (the operands' own D: they are never padded).

A paged cache whose sequence is split across ranks runs the paged
kernel's partial mode on each rank's span, `sla_decode_paged_partial`:
the span's re-based LUT (`span_lut`) and the span's columns of the page
table, the rank's pools read in place, the same merged record as
`sla_decode_partial` (bitwise that mode on the page-gathered view, at
every split width), merged by `sla_decode_combine` unchanged. Counted by
`PAGED_PARTIAL_LAUNCHES` (and `PAGED_PARTIAL_HEAD_DIMS`) apart; its twin
is `sla_decode_paged_partial_plain`.
"""
from __future__ import annotations

import collections
import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.core.config import SLAConfig
from repro_torch.kernels.sla_fwd import (EPS, MAX_HEAD_DIM, NEG_INF,
                                         check_operands)

LAUNCHES = 0  # kernel calls in this process (plain-twin calls excluded)
PAGED_LAUNCHES = 0  # the paged kernel's calls, counted apart
HEAD_DIMS = collections.Counter()  # LAUNCHES by the head dim run at
PAGED_HEAD_DIMS = collections.Counter()  # PAGED_LAUNCHES alike
PARTIAL_LAUNCHES = 0  # the partial mode's calls, counted apart
PARTIAL_HEAD_DIMS = collections.Counter()  # PARTIAL_LAUNCHES alike
PAGED_PARTIAL_LAUNCHES = 0  # the paged partial mode's calls, apart
PAGED_PARTIAL_HEAD_DIMS = collections.Counter()  # and alike
SPLITS_PER_SM = 2  # the split grid covers every SM at least this often
MAX_SPLIT_WIDTH = 4  # and no block walks more slots, one after another

_I, _F, _P, _L = ctypes.c_int, ctypes.c_float, ctypes.c_void_p, \
    ctypes.c_longlong
_ARGTYPES = [_P] * 17 + [_I] * 7 + [_F] + [_L] * 6 + [_I] * 4 + [_P]
_PAGED_ARGTYPES = [_P] * 16 + [_I] * 8 + [_F] + [_L] * 6 + [_I] * 3 + [_P]
_PARTIAL_ARGTYPES = [_P] * 13 + [_I] * 7 + [_F] + [_L] * 6 + [_I] * 3 + [_P]
_PAGED_PARTIAL_ARGTYPES = ([_P] * 12 + [_I] * 8 + [_F] + [_L] * 6
                           + [_I] * 3 + [_P])
_MAX_GRID = 65535  # the split grid's C and BH axes


@functools.cache
def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import _build
    lib = _build.load("sla_decode")
    lib.sla_decode_launch.argtypes = _ARGTYPES
    lib.sla_decode_launch.restype = ctypes.c_int
    lib.sla_decode_paged_launch.argtypes = _PAGED_ARGTYPES
    lib.sla_decode_paged_launch.restype = ctypes.c_int
    lib.sla_decode_partial_launch.argtypes = _PARTIAL_ARGTYPES
    lib.sla_decode_partial_launch.restype = ctypes.c_int
    lib.sla_decode_paged_partial_launch.argtypes = _PAGED_PARTIAL_ARGTYPES
    lib.sla_decode_paged_partial_launch.restype = ctypes.c_int
    lib.sla_decode_error_string.argtypes = [ctypes.c_int]
    lib.sla_decode_error_string.restype = ctypes.c_char_p
    return lib


def choose_split_width(rows: int, k_sel: int, sms: int) -> int:
    """The LUT slots each block of the split kernel walks: the largest
    width w <= MAX_SPLIT_WIDTH whose ceil(K / w) splits of each of `rows`
    (BH * C) rows give at least SPLITS_PER_SM blocks per SM (w = 1 where
    even that falls short). A block walks its slots one after another, so
    the cap bounds the longest block. A function of the shapes and the SM
    count only."""
    want = min(k_sel, -(-SPLITS_PER_SM * sms // max(rows, 1)))
    widest = k_sel if want <= 1 else -(-k_sel // (want - 1)) - 1
    return min(widest, MAX_SPLIT_WIDTH)


def _check_width(width, k_sel: int, name: str):
    if width is not None and (isinstance(width, bool) or not isinstance(
            width, int) or not 1 <= width <= k_sel):
        raise ValueError(f"{name}: split_width must be an int in 1..{k_sel} "
                         f"(K), got {width!r}")


@functools.cache
def sm_count(device: torch.device) -> int:
    """The streaming multiprocessors of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def split_geometry(q, lut, width=None, sms=None) -> dict:
    """The split both kernels take for q (BH, C, D) and lut (BH, C, K)
    on a card of `sms` SMs (default: the card that holds q): the width
    (forced, or `choose_split_width`), the splits per row, and the split
    kernel's blocks (one more a row for the totals' product; the combine
    kernel adds one a row)."""
    if sms is None:
        sms = sm_count(q.device)
    rows, k_sel = q.shape[0] * q.shape[1], lut.shape[-1]
    w = width if width is not None else choose_split_width(rows, k_sel, sms)
    nsplit = -(-k_sel // w)
    return dict(split_width=w, nsplit=nsplit, grid_ctas=rows * (nsplit + 1))


def sla_decode(lut, cnt, marg, posv, q, qp, k, v, hblk, zblk, hdiag, zdiag,
               htot, ztot, *, scale: float, block_kv: int, group: int,
               split_width=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the fused decode on the flat layout of `_fused_decode`.

    Args:
      lut:    (BH, C, K) int32 critical block ids (padded slots repeat the
              first); cnt, marg: (BH, C) int32; posv: (BH,) int32 base
              positions (token c sits at posv + c).
      q, qp:  (BH, C, D) f32 (qp = phi(q)).
      k, v:   (BH_kv, Tn, bkv, D) f32 or bf16, BH = BH_kv * group.
      hblk:   (BH_kv, Tn, D, D) f32; zblk: (BH_kv, Tn, D) f32.
      hdiag:  (BH_kv, C, D, D) f32 per-token diagonal partials, zdiag
              (BH_kv, C, D) f32; or both None (live-row decode: the
              diagonal block is read from hblk/zblk in place).
      htot:   (BH_kv, C, D, D) f32 per-token totals, ztot (BH_kv, C, D);
              or one running total per kv head, (BH_kv, D, D) / (BH_kv, D).
      split_width: LUT slots a split walks, 1..K; None: the card's
              `choose_split_width`, or the reference's unsplit order on
              CPU.

    Returns (o_s, o_l), both (BH, C, D) f32.
    """
    _check_width(split_width, lut.shape[-1], "sla_decode")
    kw = dict(scale=scale, block_kv=block_kv, group=group,
              split_width=split_width)
    args = (lut, cnt, marg, posv, q, qp, k, v, hblk, zblk, hdiag, zdiag,
            htot, ztot)
    if q.device.type == "cpu":
        return sla_decode_plain(*args, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"sla_decode runs on CUDA or CPU tensors, got "
                         f"{q.device}")
    return _launch(*args, **kw)


def _check(lut, cnt, marg, posv, q, qp, k, v, hblk, zblk, hdiag, zdiag,
           htot, ztot, block_kv, group):
    if k.ndim != 4 or v.shape != k.shape:
        raise ValueError("sla_decode: k and v must be (BH_kv, Tn, bkv, D)")
    bh_kv, tn, bkv, d = k.shape
    if bkv != block_kv:
        raise ValueError(f"sla_decode: k blocks of {bkv} rows, block_kv "
                         f"{block_kv}")
    if (hdiag is None) != (zdiag is None):
        raise ValueError("sla_decode: give both hdiag and zdiag, or neither")
    ts = dict(lut=lut, cnt=cnt, marg=marg, posv=posv, q=q, qp=qp,
              k=k.view(bh_kv, tn * bkv, d), v=v.view(bh_kv, tn * bkv, d),
              hblk=hblk, zblk=zblk, htot=htot, ztot=ztot, hdiag=hdiag,
              zdiag=zdiag)
    ts = {name: t for name, t in ts.items() if t is not None}  # partial
    f32 = tuple(n for n in ("qp", "hblk", "zblk", "htot", "ztot", "hdiag",
                            "zdiag") if n in ts)
    check_operands("sla_decode", ts, f32,
                   tuple(n for n in ("lut", "cnt", "marg", "posv")
                         if n in ts), 1, block_kv, q_f32=True)
    bh, c, _ = q.shape
    if bh != bh_kv * group:
        raise ValueError(f"sla_decode: {bh} q rows are not {bh_kv} kv "
                         f"heads x group {group}")
    if bh > _MAX_GRID or c > _MAX_GRID:
        raise ValueError(f"sla_decode kernel takes at most {_MAX_GRID} q "
                         f"rows and chunk tokens, got {bh} x {c}")
    if lut.ndim != 3 or tuple(lut.shape[:2]) != (bh, c) or lut.shape[2] < 1:
        raise ValueError(f"sla_decode: lut must be ({bh}, {c}, K>=1), got "
                         f"{tuple(lut.shape)}")
    _check_tile("sla_decode", bkv, d, k.element_size())
    per_tok = (c,) if htot is not None and htot.ndim == 4 else ()
    want = dict(cnt=(bh, c), marg=(bh, c), posv=(bh,), qp=(bh, c, d),
                hblk=(bh_kv, tn, d, d), zblk=(bh_kv, tn, d),
                htot=(bh_kv, *per_tok, d, d), ztot=(bh_kv, *per_tok, d),
                hdiag=(bh_kv, c, d, d), zdiag=(bh_kv, c, d))
    for name, shape in want.items():
        if name in ts and tuple(ts[name].shape) != shape:
            raise ValueError(f"sla_decode: {name} is "
                             f"{tuple(ts[name].shape)}, expected {shape}")
    for name in ("q", "qp", "k", "v", "hblk", "zblk", "htot", "ztot",
                 "hdiag", "zdiag"):
        if name in ts and ts[name].data_ptr() % 16:
            raise ValueError(f"sla_decode: {name} must be 16-byte aligned")


def _check_tile(name: str, bkv: int, d: int, esize: int):
    """The split kernel copies each K and V tile whole (a 1-D bulk copy):
    a tile of bkv x D elements must be a multiple of 16 bytes."""
    if (bkv * d * esize) % 16:
        raise ValueError(f"{name} kernel takes K/V blocks of a multiple of "
                         f"16 bytes, got {bkv} x {d} of {esize} bytes")


def _workspace(q, lut, width):
    """The split's width, splits per row and the f32 workspace of the
    partial records (csrc/sla_decode.cu: BH C (nsplit + 1) records of
    4 + 2 D floats; the kernel writes every one)."""
    geo = split_geometry(q, lut, width)
    work = torch.empty((geo["grid_ctas"] * (4 + 2 * q.shape[-1]),),
                       dtype=torch.float32, device=q.device)
    return geo["split_width"], geo["nsplit"], work


def _launch(lut, cnt, marg, posv, q, qp, k, v, hblk, zblk, hdiag, zdiag,
            htot, ztot, *, scale, block_kv, group, split_width):
    global LAUNCHES
    _check(lut, cnt, marg, posv, q, qp, k, v, hblk, zblk, hdiag, zdiag,
           htot, ztot, block_kv, group)
    lib = _lib()
    bh, c, d = q.shape
    tn, k_sel = k.shape[1], lut.shape[-1]
    width, nsplit, work = _workspace(q, lut, split_width)
    o_s = torch.empty((bh, c, d), dtype=torch.float32, device=q.device)
    o_l = torch.empty_like(o_s)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sla_decode_launch(
            lut.data_ptr(), cnt.data_ptr(), marg.data_ptr(),
            posv.data_ptr(), q.data_ptr(), qp.data_ptr(), k.data_ptr(),
            v.data_ptr(), hblk.data_ptr(), zblk.data_ptr(),
            None if hdiag is None else hdiag.data_ptr(),
            None if zdiag is None else zdiag.data_ptr(), htot.data_ptr(),
            ztot.data_ptr(), work.data_ptr(), o_s.data_ptr(),
            o_l.data_ptr(), bh, c, k_sel, tn, d, block_kv, group,
            float(scale), k.stride(0), k.stride(1), hblk.stride(0),
            hblk.stride(1), zblk.stride(0), zblk.stride(1),
            int(htot.ndim == 4), width, nsplit,
            int(k.dtype == torch.bfloat16), stream)
    if err != 0:
        msg = lib.sla_decode_error_string(err).decode()
        raise RuntimeError(f"sla_decode kernel launch failed: CUDA error "
                           f"{err} ({msg})")
    LAUNCHES += 1
    HEAD_DIMS[d] += 1
    return o_s, o_l


def sla_decode_plain(lut, cnt, marg, posv, q, qp, k, v, hblk, zblk, hdiag,
                     zdiag, htot, ztot, *, scale: float, block_kv: int,
                     group: int, split_width=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain-PyTorch twin of the kernel (the reference's `_decode_math` on
    the flat layout): gather the K selected blocks of every (bh, c), mask
    dead slots and columns past pos + c, one softmax over K * bkv scores,
    and the subtractive linear branch with the diagonal substitution. A
    block id outside [0, Tn) is clamped into it, as the kernel does.
    With `split_width` w, the kernel's split-and-combine instead: one
    partial record per w slots, merged in split order. Same arguments
    and outputs as `sla_decode`; arithmetic in f32; differentiable with
    respect to every float input."""
    kvh = (torch.arange(lut.shape[0], device=q.device) // group)[
        :, None, None]
    j = lut.long().clamp(0, k.shape[1] - 1)  # (BH, C, K), as the kernel
    blocks = (k[kvh, j], v[kvh, j], hblk[kvh, j], zblk[kvh, j])
    return _plain_math(j.to(lut.dtype), cnt, marg, posv, q, qp, blocks,
                       hdiag, zdiag, htot, ztot, scale, block_kv, group,
                       split_width)


def _plain_math(lut, cnt, marg, posv, q, qp, blocks, hdiag, zdiag, htot,
                ztot, scale, block_kv, group, split_width=None):
    """The twins' shared math on gathered blocks: kg, vg (BH, C, K, bkv,
    D) and hg (BH, C, K, D, D), zg (BH, C, K, D), the K selected blocks
    of every (bh, c). `split_width` None: the reference's order (one
    softmax over all K * bkv scores); else `_split_combine`'s."""
    bh, c, k_sel = lut.shape
    dev = q.device
    bkv = block_kv
    kvh = (torch.arange(bh, device=dev) // group)[:, None, None]
    j = lut.long()  # (BH, C, K)
    kg, vg, hg, zg = blocks
    kg = kg.float()  # (BH, C, K, bkv, D)
    s = torch.einsum("bcd,bckvd->bckv", q.float(), kg) * scale
    pos_tok = posv.long()[:, None] + torch.arange(c, device=dev)  # (BH, C)
    cols = j[..., None] * bkv + torch.arange(bkv, device=dev)
    live = torch.arange(k_sel, device=dev) < cnt[..., None]  # (BH, C, K)
    # dead slots contribute exact zeros, whatever their blocks hold (the
    # kernel never reads them)
    vg = torch.where(live[..., None, None], vg.float(),
                     torch.zeros((), device=dev))
    ok = (cols <= pos_tok[..., None, None]) & live[..., None]
    sf = torch.where(ok, s, torch.full_like(s, NEG_INF))
    # subtractive marginal aggregation; the in-flight diagonal block reads
    # its per-token partial where one is given
    kv1 = kvh[:, 0, 0]
    if hdiag is not None:
        is_diag = j == (pos_tok // bkv)[..., None]  # (BH, C, K)
        hg = torch.where(is_diag[..., None, None], hdiag[kv1][:, :, None],
                         hg)
        zg = torch.where(is_diag[..., None], zdiag[kv1][:, :, None], zg)
    hg = torch.where(live[..., None, None], hg, torch.zeros_like(hg))
    zg = torch.where(live[..., None], zg, torch.zeros_like(zg))
    ht, zt = htot[kv1], ztot[kv1]
    if htot.ndim == 3:  # one running total, every token
        ht, zt = ht[:, None], zt[:, None]
    qpf = qp.float()
    if split_width is None:
        sf = sf.reshape(bh, c, k_sel * bkv)
        m = sf.amax(dim=-1, keepdim=True)
        p = torch.exp(sf - m)
        o_s = torch.einsum("bck,bckd->bcd", p / p.sum(dim=-1, keepdim=True),
                           vg.reshape(bh, c, k_sel * bkv, -1))
        h_m = ht - hg.sum(dim=2)  # (BH, C, D, D)
        z_m = zt - zg.sum(dim=2)
        num = torch.einsum("bcd,bcde->bce", qpf, h_m)
        den = (qpf * z_m).sum(dim=-1, keepdim=True)
    else:
        o_s, num, den = _split_combine(sf, live, vg, hg, zg, qpf, ht, zt,
                                       split_width)
    ok_l = den > EPS
    o_l = torch.where(ok_l, num / torch.where(ok_l, den,
                                              torch.ones_like(den)),
                      torch.zeros_like(num))
    o_l = torch.where(marg[..., None] > 0, o_l, torch.zeros_like(o_l))
    return o_s, o_l


def _split_records(sf, live, vg, hg, zg, qpf, width):
    """The kernels' split records, merged, on the twins' masked scores sf
    (BH, C, K, bkv; -1e30 where masked) and gathered, zeroed-when-dead vg,
    hg, zg: split n walks the live slots of [n w, (n + 1) w) and keeps its
    own max m_n, sum l_n (its masked columns count when all of its
    columns are masked, as in the kernel; slots past cnt never count),
    unnormalised acc_n, hpart_n = phi(q) sum H_j and zpart_n; the records
    merge in split order. Returns the merged (m, l, acc, hsel, zsel):
    (BH, C), (BH, C), (BH, C, D), (BH, C, D), (BH, C)."""
    bh, c, k_sel, bkv = sf.shape
    nsplit = -(-k_sel // width)
    pad = nsplit * width - k_sel

    def splits(x, fill):  # (BH, C, K, ...) -> (BH, C, nsplit, w, ...)
        if pad:
            x = torch.cat([x, x.new_full((bh, c, pad, *x.shape[3:]), fill)],
                          dim=2)
        return x.reshape(bh, c, nsplit, width, *x.shape[3:])

    walked = splits(live, False)[..., None]  # (BH, C, n, w, 1)
    sfs = splits(sf, NEG_INF)
    m_n = torch.where(walked, sfs, torch.full_like(sfs, NEG_INF)).amax(
        dim=(3, 4))  # (BH, C, n): -1e30 for a split past cnt
    p = torch.where(walked, torch.exp(sfs - m_n[..., None, None]),
                    torch.zeros_like(sfs))
    l_n = p.sum(dim=(3, 4))
    acc_n = torch.einsum("bcnwt,bcnwtd->bcnd", p, splits(vg, 0.0))
    h_n = torch.einsum("bcd,bcnwde->bcne", qpf, splits(hg, 0.0))
    z_n = torch.einsum("bcd,bcnwd->bcn", qpf, splits(zg, 0.0))
    m = m_n.amax(dim=-1)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(acc_n[:, :, 0])
    hsel, zsel = torch.zeros_like(acc), torch.zeros_like(m)
    for n in range(nsplit):  # the combine kernel's order
        f = torch.exp(m_n[..., n] - m)
        l = l + l_n[..., n] * f
        acc = acc + acc_n[:, :, n] * f[..., None]
        hsel = hsel + h_n[:, :, n]
        zsel = zsel + z_n[..., n]
    return m, l, acc, hsel, zsel


def _split_combine(sf, live, vg, hg, zg, qpf, ht, zt, width):
    """`_split_records` finished as the combine kernel finishes them:
    returns (o_s, num, den) for the linear branch's phi(q) Htot - sum
    hpart, phi(q) Ztot - sum zpart."""
    bh, c = sf.shape[:2]
    _, l, acc, hsel, zsel = _split_records(sf, live, vg, hg, zg, qpf, width)
    o_s = acc / torch.where(l > 0, l, torch.ones_like(l))[..., None]
    d = qpf.shape[-1]
    num = torch.einsum("bcd,bcde->bce", qpf, ht.expand(bh, c, d, d)) - hsel
    den = ((qpf * zt.expand(bh, c, d)).sum(dim=-1) - zsel)[..., None]
    return o_s, num, den


def sla_decode_partial(lut, cnt, posv, q, qp, k, v, hblk, zblk,
                       hdiag=None, zdiag=None, *, scale: float,
                       block_kv: int, group: int,
                       split_width=None) -> torch.Tensor:
    """Kernel 4 on one rank's span of a split cache, before any divide.

    Args:
      lut:    (BH, C, K) int32 each token's blocks that lie in this span,
              in the span's own block ids (padded slots repeat the
              first); cnt (BH, C) int32 how many; posv (BH,) int32 each
              row's position less the span's first position (token c sits
              at posv + c, below 0 where it comes before the span; the
              rows of different slots at their own positions), so the
              causal mask sees global columns.
      q, qp:  (BH, C, D) f32 (qp = phi(q)).
      k, v:   (BH_kv, Tn_span, bkv, D) f32 or bf16; hblk (BH_kv, Tn_span,
              D, D) f32; zblk (BH_kv, Tn_span, D) f32: the span's blocks.
      hdiag, zdiag: (BH_kv, C, D, D) / (BH_kv, C, D) f32 each token's
              partial of its diagonal block (a chunk still filling it), read
              where that block is in the span; or both None (the stored
              block).
      split_width: as `sla_decode`'s.

    Returns (BH, C, 2 D + 3) f32 records (m, l, acc[D], hsel[D], zsel):
    the max over the walked columns (-1e30 where none), the sum of
    exponentials against it, the unnormalised sparse output, and phi(q)
    times the sum of the walked blocks' H and Z. CPU tensors run
    `sla_decode_partial_plain`; CUDA tensors launch the kernel (a refused
    operand or a failed launch raises; there is no fallback)."""
    _check_width(split_width, lut.shape[-1], "sla_decode_partial")
    args = (lut, cnt, posv, q, qp, k, v, hblk, zblk, hdiag, zdiag)
    kw = dict(scale=scale, block_kv=block_kv, group=group,
              split_width=split_width)
    if q.device.type == "cpu":
        return sla_decode_partial_plain(*args, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"sla_decode_partial runs on CUDA or CPU tensors, "
                         f"got {q.device}")
    return _launch_partial(*args, **kw)


def _launch_partial(lut, cnt, posv, q, qp, k, v, hblk, zblk, hdiag, zdiag, *,
                    scale, block_kv, group, split_width):
    global PARTIAL_LAUNCHES
    _check(lut, cnt, None, posv, q, qp, k, v, hblk, zblk, hdiag, zdiag, None,
           None, block_kv, group)
    lib = _lib()
    bh, c, d = q.shape
    tn, k_sel = k.shape[1], lut.shape[-1]
    width, nsplit, work = _workspace(q, lut, split_width)
    rec = torch.empty((bh, c, 2 * d + 3), dtype=torch.float32,
                      device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sla_decode_partial_launch(
            lut.data_ptr(), cnt.data_ptr(), posv.data_ptr(), q.data_ptr(),
            qp.data_ptr(), k.data_ptr(), v.data_ptr(), hblk.data_ptr(),
            zblk.data_ptr(), None if hdiag is None else hdiag.data_ptr(),
            None if zdiag is None else zdiag.data_ptr(), work.data_ptr(),
            rec.data_ptr(), bh, c, k_sel,
            tn, d, block_kv, group, float(scale), k.stride(0), k.stride(1),
            hblk.stride(0), hblk.stride(1), zblk.stride(0), zblk.stride(1),
            width, nsplit, int(k.dtype == torch.bfloat16), stream)
    if err != 0:
        msg = lib.sla_decode_error_string(err).decode()
        raise RuntimeError(f"sla_decode_partial kernel launch failed: CUDA "
                           f"error {err} ({msg})")
    PARTIAL_LAUNCHES += 1
    PARTIAL_HEAD_DIMS[d] += 1
    return rec


def sla_decode_partial_plain(lut, cnt, posv, q, qp, k, v, hblk, zblk,
                             hdiag=None, zdiag=None, *, scale: float,
                             block_kv: int, group: int,
                             split_width=None) -> torch.Tensor:
    """Plain-PyTorch twin of `sla_decode_partial`: the twins' gathers and
    masks (`sla_decode_plain`, the diagonal substitution where hdiag is
    given), then the split records merged in split order
    (`_split_records`); `split_width` None walks every slot in one split,
    the unsplit twin's order (one max, one sum over all K * bkv scores).
    Same arguments and output as `sla_decode_partial`."""
    kvh = (torch.arange(lut.shape[0], device=q.device) // group)[
        :, None, None]
    j = lut.long().clamp(0, k.shape[1] - 1)
    return _partial_math(j, cnt, posv, q, qp, (k[kvh, j], v[kvh, j],
                                               hblk[kvh, j], zblk[kvh, j]),
                         hdiag, zdiag, scale, block_kv, group, split_width)


def _partial_math(j, cnt, posv, q, qp, blocks, hdiag, zdiag, scale,
                  block_kv, group, split_width):
    """The partial twins' shared math on the gathered blocks of every
    (bh, c) (kg, vg (BH, C, K, bkv, D), hg (BH, C, K, D, D), zg (BH, C,
    K, D)) at the clamped logical ids j (BH, C, K)."""
    bh, c, k_sel = j.shape
    dev = q.device
    bkv = block_kv
    kvh = (torch.arange(bh, device=dev) // group)[:, None, None]
    kg, vg, hg, zg = blocks
    s = torch.einsum("bcd,bckvd->bckv", q.float(), kg.float()) * scale
    pos_tok = posv.long()[:, None] + torch.arange(c, device=dev)
    cols = j[..., None] * bkv + torch.arange(bkv, device=dev)
    live = torch.arange(k_sel, device=dev) < cnt[..., None]
    vg = torch.where(live[..., None, None], vg.float(),
                     torch.zeros((), device=dev))
    ok = (cols <= pos_tok[..., None, None]) & live[..., None]
    sf = torch.where(ok, s, torch.full_like(s, NEG_INF))
    if hdiag is not None:  # no diagonal block for a token before the span
        kv1 = kvh[:, 0, 0]
        is_diag = ((j == (pos_tok // bkv)[..., None])
                   & (pos_tok >= 0)[..., None])
        hg = torch.where(is_diag[..., None, None], hdiag[kv1][:, :, None],
                         hg)
        zg = torch.where(is_diag[..., None], zdiag[kv1][:, :, None], zg)
    hg = torch.where(live[..., None, None], hg, torch.zeros_like(hg))
    zg = torch.where(live[..., None], zg, torch.zeros_like(zg))
    m, l, acc, hsel, zsel = _split_records(
        sf, live, vg, hg, zg, qp.float(),
        k_sel if split_width is None else split_width)
    return torch.cat([m[..., None], l[..., None], acc, hsel,
                      zsel[..., None]], dim=-1)


def span_lut(lut: torch.Tensor, cnt: torch.Tensor, first: int,
             blocks: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The live row's blocks that lie in a span of `blocks` blocks from
    block `first`, as `sla_decode_partial` takes them: lut (..., K) global
    block ids, cnt (...) the live slots. Returns (lut, cnt) of the span:
    its live slots first, in slot order, as the span's own ids
    (id - first), the padding repeating the first of them (0 where the
    span holds none), both int32."""
    k_sel = lut.shape[-1]
    slot = torch.arange(k_sel, device=lut.device)
    inside = ((slot < cnt[..., None]) & (lut >= first)
              & (lut < first + blocks))
    order = torch.argsort((~inside).to(torch.int32), dim=-1, stable=True)
    local = torch.gather(lut.long() - first, -1, order).clamp(0, blocks - 1)
    n = inside.sum(dim=-1)
    local = torch.where(slot < n[..., None], local, local[..., :1])
    return local.int(), n.int()


def sla_decode_paged_partial(lut, pt, cnt, posv, q, qp, k, v, hblk, zblk,
                             *, scale: float, block_kv: int, group: int,
                             split_width=None) -> torch.Tensor:
    """Kernel 5 on one rank's span of a split paged cache, before any
    divide (`sla_decode_partial`'s record, read through a page table).

    Args:
      lut:    (BH, 1, K) int32 the live row's blocks that lie in this
              span, in the span's own logical ids (`span_lut`; padded
              slots repeat the first); cnt (BH, 1) int32 how many; posv
              (BH,) int32 each row's position less the span's first
              position. Row bh = b * H + h.
      pt:     (B, Tn_span) int32 the span's page table: the span's
              logical block j of slot b lives in page pt[b, j] of the
              rank's pools.
      q, qp:  (BH, 1, D) f32 (qp = phi(q)).
      k, v:   (P, Hkv, bkv, D) f32 or bf16 page pools, hblk (P, Hkv, D,
              D) and zblk (P, Hkv, D) f32, as `sla_decode_paged`'s.
      split_width: as `sla_decode`'s; the chosen width is the one
              `sla_decode_partial` takes on the same rows.

    Returns (BH, 1, 2 D + 3) f32 records (m, l, acc[D], hsel[D], zsel),
    bitwise `sla_decode_partial` on the page-gathered view of the span.
    CPU tensors run `sla_decode_paged_partial_plain`; CUDA tensors
    launch the kernel (a refused operand or a failed launch raises;
    there is no fallback)."""
    _check_width(split_width, lut.shape[-1], "sla_decode_paged_partial")
    args = (lut, pt, cnt, posv, q, qp, k, v, hblk, zblk)
    kw = dict(scale=scale, block_kv=block_kv, group=group,
              split_width=split_width)
    if q.device.type == "cpu":
        return sla_decode_paged_partial_plain(*args, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"sla_decode_paged_partial runs on CUDA or CPU "
                         f"tensors, got {q.device}")
    return _launch_paged_partial(*args, **kw)


def _launch_paged_partial(lut, pt, cnt, posv, q, qp, k, v, hblk, zblk, *,
                          scale, block_kv, group, split_width):
    global PAGED_PARTIAL_LAUNCHES
    _check_paged(lut, pt, cnt, None, posv, q, qp, k, v, hblk, zblk, None,
                 None, block_kv, group, "sla_decode_paged_partial")
    lib = _lib()
    bh, _, d = q.shape
    k_sel = lut.shape[-1]
    width, nsplit, work = _workspace(q, lut, split_width)
    rec = torch.empty((bh, 1, 2 * d + 3), dtype=torch.float32,
                      device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sla_decode_paged_partial_launch(
            lut.data_ptr(), pt.data_ptr(), cnt.data_ptr(), posv.data_ptr(),
            q.data_ptr(), qp.data_ptr(), k.data_ptr(), v.data_ptr(),
            hblk.data_ptr(), zblk.data_ptr(), work.data_ptr(),
            rec.data_ptr(), bh, k_sel, pt.shape[1], k.shape[0], d,
            block_kv, group, k.shape[1], float(scale), k.stride(1),
            k.stride(0), hblk.stride(1), hblk.stride(0), zblk.stride(1),
            zblk.stride(0), width, nsplit, int(k.dtype == torch.bfloat16),
            stream)
    if err != 0:
        msg = lib.sla_decode_error_string(err).decode()
        raise RuntimeError(f"sla_decode_paged_partial kernel launch failed: "
                           f"CUDA error {err} ({msg})")
    PAGED_PARTIAL_LAUNCHES += 1
    PAGED_PARTIAL_HEAD_DIMS[d] += 1
    return rec


def sla_decode_paged_partial_plain(lut, pt, cnt, posv, q, qp, k, v, hblk,
                                   zblk, *, scale: float, block_kv: int,
                                   group: int, split_width=None
                                   ) -> torch.Tensor:
    """Plain-PyTorch twin of `sla_decode_paged_partial`: the pools'
    blocks gathered through pt[b, lut] (the logical ids, clamped as the
    kernel clamps them, keep the masking), then `sla_decode_partial_plain`'s
    math. Same arguments and output as `sla_decode_paged_partial`."""
    bh = lut.shape[0]
    b, tn = pt.shape
    hkv = k.shape[1]
    rows = torch.arange(bh, device=q.device)
    slot = (rows // (bh // b))[:, None, None]
    kvh = ((rows // group) % hkv)[:, None, None]
    j = lut.long().clamp(0, tn - 1)
    page = pt.long()[slot, j].clamp(0, k.shape[0] - 1)
    return _partial_math(j, cnt, posv, q, qp, (k[page, kvh], v[page, kvh],
                                               hblk[page, kvh],
                                               zblk[page, kvh]),
                         None, None, scale, block_kv, group, split_width)


def sla_decode_combine(records: torch.Tensor, qhtot: torch.Tensor,
                       qztot: torch.Tensor, marg: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 4's output from every span's partial records.

    records (P, ..., 2 D + 3) f32 in span order, each (m, l, acc[D],
    hsel[D], zsel) (`sla_decode_partial`); qhtot (R, ..., D) phi(q) Htot
    over each part of Htot's D_k rows (R = 1 where Htot is whole), in rank
    order; qztot (...) phi(q) Ztot; marg (...) the live row's marginal
    block count (the leading dims may hold a chunk's tokens, each with
    its own totals and live row). The records are rescaled to the global max and summed in
    span order, the qhtot parts in rank order, so every rank gets the same
    bits. Returns (o_s, o_l), both (..., D) f32: O^s = acc / l (l = 1
    where l = 0) and O^l = (phi(q) Htot - sum hsel) / (phi(q) Ztot - sum
    zsel), zero where the denominator is <= EPS or marg is 0 (the
    unsplit kernel's rules)."""
    d = (records.shape[-1] - 3) // 2
    m, l = records[..., 0], records[..., 1]
    acc, hsel = records[..., 2:2 + d], records[..., 2 + d:2 + 2 * d]
    zsel = records[..., 2 + 2 * d]
    top = m.amax(dim=0)
    lsum, asum = torch.zeros_like(l[0]), torch.zeros_like(acc[0])
    hsum, zsum = torch.zeros_like(hsel[0]), torch.zeros_like(zsel[0])
    for r in range(records.shape[0]):
        f = torch.exp(m[r] - top)
        lsum = lsum + l[r] * f
        asum = asum + acc[r] * f[..., None]
        hsum = hsum + hsel[r]
        zsum = zsum + zsel[r]
    o_s = asum / torch.where(lsum > 0, lsum, torch.ones_like(lsum))[..., None]
    num = qhtot[0]
    for r in range(1, qhtot.shape[0]):
        num = num + qhtot[r]
    num = num - hsum
    den = qztot - zsum
    live = (den > EPS) & (marg > 0)
    o_l = torch.where(live[..., None],
                      num / torch.where(live, den, torch.ones_like(den))[
                          ..., None], torch.zeros_like(num))
    return o_s, o_l


def sla_decode_paged(lut, pt, cnt, marg, posv, q, qp, k, v, hblk, zblk,
                     htot, ztot, *, scale: float, block_kv: int, group: int,
                     split_width=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the paged decode kernel (`_decode_kernel_paged`'s counterpart,
    single token, live row) on the layer's page pools in place.

    Args:
      lut:    (BH, 1, K) int32 LOGICAL block ids of the live row (padded
              slots repeat the first); cnt, marg: (BH, 1) int32; posv:
              (BH,) int32 positions. Row bh = b * H + h.
      pt:     (B, Tn) int32 page table: logical block j of slot b lives in
              page pt[b, j].
      q, qp:  (BH, 1, D) f32 (qp = phi(q)).
      k, v:   (P, Hkv, bkv, D) f32 or bf16 page pools, any page and head
              strides (rows of D contiguous); hblk (P, Hkv, D, D) f32,
              zblk (P, Hkv, D) f32 likewise. q head h reads kv head
              (h // group) % Hkv.
      htot, ztot: (B * Hkv, D, D) / (B * Hkv, D) f32 running totals.
      split_width: as `sla_decode`'s; the chosen width is the one
              `sla_decode` takes on the same rows.

    Returns (o_s, o_l), both (BH, 1, D) f32. CPU tensors run
    `sla_decode_paged_plain`; CUDA tensors launch the kernel (a refused
    operand or a failed launch raises; there is no fallback)."""
    _check_width(split_width, lut.shape[-1], "sla_decode_paged")
    args = (lut, pt, cnt, marg, posv, q, qp, k, v, hblk, zblk, htot, ztot)
    kw = dict(scale=scale, block_kv=block_kv, group=group,
              split_width=split_width)
    if q.device.type == "cpu":
        return sla_decode_paged_plain(*args, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"sla_decode_paged runs on CUDA or CPU tensors, got "
                         f"{q.device}")
    return _launch_paged(*args, **kw)


def _check_paged(lut, pt, cnt, marg, posv, q, qp, k, v, hblk, zblk, htot,
                 ztot, block_kv, group, name="sla_decode_paged"):
    """The paged kernel's operands (the partial mode's: no marg and no
    totals, given as None)."""
    ts = dict(lut=lut, pt=pt, cnt=cnt, marg=marg, posv=posv, q=q, qp=qp,
              k=k, v=v, hblk=hblk, zblk=zblk, htot=htot, ztot=ztot)
    ts = {key: t for key, t in ts.items() if t is not None}
    for key, t in ts.items():
        if t.device != q.device:
            raise ValueError(f"{name}: {key} is on {t.device}, q on "
                             f"{q.device}")
    for key in ("lut", "pt", "cnt", "marg", "posv"):
        if key in ts and ts[key].dtype != torch.int32:
            raise TypeError(f"{name}: {key} must be int32")
    for key in ("q", "qp", "hblk", "zblk", "htot", "ztot"):
        if key in ts and ts[key].dtype != torch.float32:
            raise TypeError(f"{name}: {key} must be float32")
    if k.dtype not in (torch.float32, torch.bfloat16) or v.dtype != k.dtype:
        raise TypeError(f"{name}: k and v must share float32 or bfloat16")
    if k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"{name}: k and v must be (P, Hkv, bkv, D) pools")
    npages, hkv, bkv, d = k.shape
    if bkv != block_kv:
        raise ValueError(f"{name}: k pages of {bkv} rows, block_kv "
                         f"{block_kv}")
    if d > MAX_HEAD_DIM or d % 4 or not 1 <= bkv <= 64:
        raise ValueError(f"{name} kernel takes head dims <= {MAX_HEAD_DIM} "
                         f"that are multiples of 4 and blocks of 1..64, got "
                         f"D {d}, bkv {bkv}")
    _check_tile(name, bkv, d, k.element_size())
    if pt.ndim != 2:
        raise ValueError(f"{name}: pt must be (B, Tn), got "
                         f"{tuple(pt.shape)}")
    b, tn = pt.shape
    bh = q.shape[0]
    if lut.ndim != 3 or lut.shape[0] != bh or lut.shape[1] != 1 \
            or lut.shape[2] < 1:
        raise ValueError(f"{name}: lut must be ({bh}, 1, K>=1), got "
                         f"{tuple(lut.shape)}")
    if bh != b * hkv * group:
        raise ValueError(f"{name}: {bh} q rows are not B {b} x {hkv} kv "
                         f"heads x group {group} (pt {tuple(pt.shape)})")
    if bh > _MAX_GRID:
        raise ValueError(f"{name} kernel takes at most {_MAX_GRID} q rows, "
                         f"got {bh}")
    want = dict(cnt=(bh, 1), marg=(bh, 1), posv=(bh,), q=(bh, 1, d),
                qp=(bh, 1, d), hblk=(npages, hkv, d, d),
                zblk=(npages, hkv, d), htot=(b * hkv, d, d),
                ztot=(b * hkv, d))
    for key, shape in want.items():
        if key in ts and tuple(ts[key].shape) != shape:
            raise ValueError(f"{name}: {key} is {tuple(ts[key].shape)}, "
                             f"expected {shape}")
    for key in ("lut", "pt", "cnt", "marg", "posv", "q", "qp", "htot",
                "ztot"):
        if key in ts and not ts[key].is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    # the pools are read in place: rows of D contiguous elements, rows of a
    # block D apart, head and page strides that keep 16-byte loads aligned
    for key, rows in (("k", True), ("v", True), ("hblk", True),
                      ("zblk", False)):
        t = ts[key]
        if t.stride(-1) != 1 or (rows and t.stride(-2) != d):
            raise ValueError(f"{name}: {key} must hold rows of {d} "
                             f"contiguous elements, got strides "
                             f"{tuple(t.stride())}")
        if (t.stride(0) * t.element_size()) % 16 or \
                (t.stride(1) * t.element_size()) % 16:
            raise ValueError(f"{name}: {key}'s page and head strides "
                             f"{tuple(t.stride()[:2])} must be multiples "
                             f"of 16 bytes")
    for key in ("q", "qp", "k", "v", "hblk", "zblk", "htot", "ztot"):
        if key in ts and ts[key].data_ptr() % 16:
            raise ValueError(f"{name}: {key} must be 16-byte aligned")


def _launch_paged(lut, pt, cnt, marg, posv, q, qp, k, v, hblk, zblk, htot,
                  ztot, *, scale, block_kv, group, split_width):
    global PAGED_LAUNCHES
    _check_paged(lut, pt, cnt, marg, posv, q, qp, k, v, hblk, zblk, htot,
                 ztot, block_kv, group)
    lib = _lib()
    bh, _, d = q.shape
    k_sel = lut.shape[-1]
    width, nsplit, work = _workspace(q, lut, split_width)
    o_s = torch.empty((bh, 1, d), dtype=torch.float32, device=q.device)
    o_l = torch.empty_like(o_s)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sla_decode_paged_launch(
            lut.data_ptr(), pt.data_ptr(), cnt.data_ptr(), marg.data_ptr(),
            posv.data_ptr(), q.data_ptr(), qp.data_ptr(), k.data_ptr(),
            v.data_ptr(), hblk.data_ptr(), zblk.data_ptr(), htot.data_ptr(),
            ztot.data_ptr(), work.data_ptr(), o_s.data_ptr(),
            o_l.data_ptr(), bh, k_sel, pt.shape[1], k.shape[0], d, block_kv,
            group, k.shape[1], float(scale), k.stride(1), k.stride(0),
            hblk.stride(1), hblk.stride(0), zblk.stride(1), zblk.stride(0),
            width, nsplit, int(k.dtype == torch.bfloat16), stream)
    if err != 0:
        msg = lib.sla_decode_error_string(err).decode()
        raise RuntimeError(f"sla_decode_paged kernel launch failed: CUDA "
                           f"error {err} ({msg})")
    PAGED_LAUNCHES += 1
    PAGED_HEAD_DIMS[d] += 1
    return o_s, o_l


def sla_decode_paged_plain(lut, pt, cnt, marg, posv, q, qp, k, v, hblk,
                           zblk, htot, ztot, *, scale: float, block_kv: int,
                           group: int, split_width=None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain-PyTorch twin of the paged kernel: `sla_decode_plain` with the
    gathers routed through pt[b, lut] into the pools (the logical ids, as
    the kernel clamps them, keep the masking), the live row's diagonal
    block read from its page, one running total per (b, kv head). Same
    arguments and outputs as `sla_decode_paged`."""
    bh = lut.shape[0]
    b, tn = pt.shape
    hkv = k.shape[1]
    dev = q.device
    rows = torch.arange(bh, device=dev)
    slot = (rows // (bh // b))[:, None, None]
    kvh = ((rows // group) % hkv)[:, None, None]
    j = lut.long().clamp(0, tn - 1)
    page = pt.long()[slot, j].clamp(0, k.shape[0] - 1)  # (BH, 1, K)
    blocks = (k[page, kvh], v[page, kvh], hblk[page, kvh], zblk[page, kvh])
    return _plain_math(j.to(lut.dtype), cnt, marg, posv, q, qp, blocks,
                       None, None, htot, ztot, scale, block_kv, group,
                       split_width)


def _flat_args(q, qp, kc, vc, hblk, zblk, hdiag, zdiag, htot, ztot, lut,
               cnt, marg, posv, block_kv):
    """Grouped (B, Hkv, G, C, ...) operands -> the flat kernel layout:
    q head (b, n, gi) is row b*H + n*G + gi, whose kv row b*Hkv + n is
    row // G, as the prefill kernel's head layout. hdiag/zdiag may be
    None, and htot/ztot may lack the C axis (live-row decode); both pass
    through without a copy."""
    b, hkv, g, c, d = q.shape
    bh, tn = b * hkv * g, kc.shape[2] // block_kv

    def kv_rows(x):
        return None if x is None else x.reshape(b * hkv, *x.shape[2:])

    return (lut.reshape(bh, c, lut.shape[-1]).int().contiguous(),
            cnt.reshape(bh, c).int().contiguous(),
            marg.reshape(bh, c).int().contiguous(),
            posv.int().repeat_interleave(hkv * g).contiguous(),
            q.reshape(bh, c, d).contiguous(),
            qp.reshape(bh, c, d).contiguous(),
            kc.reshape(b * hkv, tn, block_kv, d),
            vc.reshape(b * hkv, tn, block_kv, d),
            hblk.reshape(b * hkv, tn, d, d), zblk.reshape(b * hkv, tn, d),
            kv_rows(hdiag), kv_rows(zdiag), kv_rows(htot), kv_rows(ztot))


def _decode_math(q, qp, kc, vc, hblk, zblk, hdiag, zdiag, htot, ztot, lut,
                 cnt, marg, posv, cfg: SLAConfig, scale: float):
    """The reference's `_decode_math` on its grouped layout: q/qp
    (B, Hkv, G, C, D) f32, kc/vc (B, Hkv, Smax, D), hblk (B, Hkv, Tn, D, D),
    zblk (B, Hkv, Tn, D), hdiag/htot (B, Hkv, C, D, D), zdiag/ztot
    (B, Hkv, C, D) (hdiag/zdiag may be None and htot/ztot may lack the C
    axis), lut (B, Hkv, G, C, K), cnt/marg (B, Hkv, G, C), posv
    (B,). Returns (o_s, o_l), both (B, Hkv, G, C, D) f32, through the
    plain twin."""
    flat = _flat_args(q, qp, kc, vc, hblk, zblk, hdiag, zdiag, htot, ztot,
                      lut, cnt, marg, posv, cfg.block_kv)
    o_s, o_l = sla_decode_plain(*flat, scale=scale, block_kv=cfg.block_kv,
                                group=q.shape[2])
    return o_s.reshape(q.shape), o_l.reshape(q.shape)


class _DecodeCore(torch.autograd.Function):
    """(O^s, O^l) through `sla_decode`; the backward is autograd over the
    plain twin (there is no backward kernel for decode, as in the
    reference). The plan's integer operands get no gradient."""

    @staticmethod
    def forward(ctx, q, qp, kc, vc, hblk, zblk, hdiag, zdiag, htot, ztot,
                lut, cnt, marg, posv, cfg: SLAConfig, scale: float):
        flat = _flat_args(q, qp, kc, vc, hblk, zblk, hdiag, zdiag, htot,
                          ztot, lut, cnt, marg, posv, cfg.block_kv)
        o_s, o_l = sla_decode(*flat, scale=scale, block_kv=cfg.block_kv,
                              group=q.shape[2])
        ctx.save_for_backward(q, qp, kc, vc, hblk, zblk, hdiag, zdiag, htot,
                              ztot, lut, cnt, marg, posv)
        ctx.cfg, ctx.scale = cfg, scale
        return o_s.reshape(q.shape), o_l.reshape(q.shape)

    @staticmethod
    def backward(ctx, do_s, do_l):
        saved = ctx.saved_tensors
        floats = [None if x is None else x.detach().requires_grad_()
                  for x in saved[:10]]
        given = [x for x in floats if x is not None]
        with torch.enable_grad():
            outs = _decode_math(*floats, *saved[10:], ctx.cfg, ctx.scale)
            pairs = [(o, g) for o, g in zip(outs, (do_s, do_l))
                     if g is not None]
            grads = iter(torch.autograd.grad(
                [o for o, _ in pairs], given, [g for _, g in pairs],
                allow_unused=True))
        out = []
        for x in saved[:10]:
            g = None if x is None else next(grads)
            out.append(None if g is None else g.to(x.dtype))
        return tuple(out) + (None,) * 6


def decode_operands(state, qg, qpg, pos):
    """The grouped operands of `_decode_math` (and of the kernel, through
    `_flat_args`) for one decode-state slice: the live-row LUT broadcast
    over the chunk; running totals and absent diagonal partials (None)
    pass through as they are, for the kernel reads them in place (the
    reference slices hdiag from hblk, the same numbers). Arguments as
    `decode_attention`. Returns (q, qp, k, v, hblk, zblk, hdiag, zdiag,
    htot, ztot, lut, cnt, marg, posv). Monolithic state only: paged state
    goes to `_decode_attention_paged`."""
    b, hkv, g, cdim, _ = qg.shape
    dev = qg.device
    lut, cnt, marg = state["lut"], state["cnt"], state["marg"]
    if lut.ndim == 3:  # (B, H, K) live row: every chunk token shares it
        lut = lut[:, :, None].expand(*lut.shape[:2], cdim, lut.shape[-1])
        cnt = cnt[..., None].expand(*cnt.shape, cdim)
        marg = marg[..., None].expand(*marg.shape, cdim)
    if not torch.is_tensor(pos):  # a fill, not a host-to-device copy
        posv = torch.full((b,), int(pos), dtype=torch.int32, device=dev)
    else:
        posv = torch.broadcast_to(pos.to(device=dev, dtype=torch.int32),
                                  (b,))
    k_sel = lut.shape[-1]
    return (qg.float(), qpg.float(), state["k"], state["v"], state["hblk"],
            state["zblk"], state.get("hdiag"), state.get("zdiag"),
            state["htot"], state["ztot"], lut.reshape(b, hkv, g, cdim, k_sel),
            cnt.reshape(b, hkv, g, cdim), marg.reshape(b, hkv, g, cdim),
            posv)


def _decode_attention_paged(state, qg, qpg, pos, scale: float):
    """Paged entry: one launch of `sla_decode_paged` against the layer's
    page pools, in place (no gathered `plut`, no copy of a pool; the
    kernel looks the pages up). Single-token steps only (the chunked path
    snapshots per-token state the paged scheduler never builds). The
    reference passes the live block's partial as hdiag; that is the
    pool's own block, which the kernel reads in place. Returns (o_s,
    o_l), both (B, Hkv, G, 1, D) f32."""
    b, hkv, g, cdim, d = qg.shape
    if cdim != 1:
        raise ValueError("paged fused decode supports single-token steps "
                         f"only (got chunk of {cdim})")
    bh = b * hkv * g
    k_sel = state["lut"].shape[-1]
    if not torch.is_tensor(pos):  # a fill, not a host-to-device copy
        posv = torch.full((b,), int(pos), dtype=torch.int32,
                          device=qg.device)
    else:
        posv = torch.broadcast_to(pos.to(device=qg.device,
                                          dtype=torch.int32), (b,))
    o_s, o_l = sla_decode_paged(
        state["lut"].reshape(bh, 1, k_sel).int().contiguous(),
        state["pt"].int().contiguous(),
        state["cnt"].reshape(bh, 1).int().contiguous(),
        state["marg"].reshape(bh, 1).int().contiguous(),
        posv.repeat_interleave(hkv * g).contiguous(),
        qg.float().reshape(bh, 1, d).contiguous(),
        qpg.float().reshape(bh, 1, d).contiguous(),
        state["k"], state["v"], state["hblk"], state["zblk"],
        state["htot"].reshape(b * hkv, d, d),
        state["ztot"].reshape(b * hkv, d),
        scale=scale, block_kv=state["k"].shape[2], group=g)
    shape = (b, hkv, g, 1, d)
    return o_s.reshape(shape), o_l.reshape(shape)


def decode_attention(state, qg, qpg, pos, cfg: SLAConfig, scale=None):
    """Fused decode attention for a chunk of C tokens.

    qg / qpg: (B, Hkv, G, C, D) grouped queries and phi(queries) (C = 1
    for single-token decode). `state`: k/v (B, Hkv, Smax, D); hblk
    (B, Hkv, Tn, D, D); zblk (B, Hkv, Tn, D); htot/ztot either running
    totals (B, Hkv, D, D) / (B, Hkv, D), broadcast to every token, or
    per-token snapshots with a C axis at dim 2; lut/cnt/marg either the
    live row (B, H, K) / (B, H) or per token with a C axis before K;
    optional per-token hdiag/zdiag (else the stored block). `pos`:
    base position, a python int or an int tensor, scalar or (B,). Returns
    (o_s, o_l), both (B, Hkv, G, C, D) f32, differentiable with respect
    to q, qp, k, v, hblk, zblk, hdiag, zdiag, htot and ztot. State that
    holds a page table `pt` (and page pools for k/v/hblk/zblk) runs the
    paged kernel (C = 1), without gradients."""
    d = qg.shape[-1]
    scale = float(d**-0.5) if scale is None else float(scale)
    if "pt" in state:
        return _decode_attention_paged(state, qg, qpg, pos, scale)
    return _DecodeCore.apply(*decode_operands(state, qg, qpg, pos),
                             cfg, scale)
