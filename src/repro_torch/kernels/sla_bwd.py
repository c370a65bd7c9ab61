"""SLA sparse-branch backward: the CUDA kernels `csrc/sla_bwd.cu` and
`csrc/sla_bwd_tc.cu`, their plain twins, and their launch counters.

Counterparts of the Pallas TPU kernels `repro.kernels.sla_bwd._dq_kernel`
(`sla_bwd_dq`) and `_dkv_kernel` (`sla_bwd_dkv`). With P = exp(S * scale
- L) recomputed from the forward's row log-sum-exp L and
dS = P * (dO V^T - D) * scale, D = rowsum(dO^s * O^s):

  sla_bwd_dq:  dQ_i = sum over the row LUT's live j of dS_ij K_j;
  sla_bwd_dkv: dK_j = sum over the column LUT's live i of dS_ij^T Q_i and
               dV_j = sum of P_ij^T dO_i, per query head (the caller sums
               a GQA group).

Each wrapper launches a kernel for CUDA tensors and runs the plain twin
(plain PyTorch walking the same LUT loop) only for CPU tensors: a CUDA
tensor gets a kernel or an exception, never the twin. Which kernel is a
rule on dtype and shape (`sla_fwd.use_tensor_cores`, the forward's rule
too, so a training step never mixes routes), not a fallback:

  * bf16 q, k, v at 64 x 64 blocks and head dims up to 128: the
    tensor-core kernels of `sla_bwd_tc.cu` (wgmma). Their precision is
    FlashAttention's: dO (cast once from f32 by the wrapper), P and dS are
    rounded to bf16 before their products; every sum is f32. Narrower
    heads are zero-padded to `TC_HEAD_DIM` (zero columns change neither S
    nor dP) and the outputs sliced back.
  * everything else (f32, other blocks): the f32-FMA kernels of
    `sla_bwd.cu`, every product in f32 from the same inputs.

A failed build or launch raises; nothing reroutes. The twins compute in
f32; with `mma_dtype=torch.bfloat16` they round dO, P and dS where the
tensor-core kernels do, the yardstick of that route's rounding.
`LAUNCHES_DQ` / `LAUNCHES_DKV` count kernel launches of either route and
nothing else, `TC_LAUNCHES_DQ` / `TC_LAUNCHES_DKV` those of the
tensor-core route.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels.sla_fwd import (NEG_INF, TC_BLOCK, TC_HEAD_DIM,
                                         check_operands, pad_head_dim,
                                         use_tensor_cores)

LAUNCHES_DQ = 0   # dQ kernel launches in this process (twin calls excluded)
LAUNCHES_DKV = 0  # dK/dV kernel launches in this process
TC_LAUNCHES_DQ = 0   # of which on the tensor-core route
TC_LAUNCHES_DKV = 0

_I, _F, _P = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
# lut, counts, q, k, v, dout, lse, dsum, dq; bh_q, bh_kv, n, d, k_sel,
# block_q, block_kv; scale; causal, is_bf16; stream
_DQ_ARGTYPES = [_P] * 9 + [_I] * 7 + [_F, _I, _I, _P]
# the same with col_lut, col_counts, ..., dk, dv and w_col for k_sel
_DKV_ARGTYPES = [_P] * 10 + [_I] * 7 + [_F, _I, _I, _P]
# {source: {launch function: argtypes}}; the tensor-core kernels take the
# same arguments without is_bf16 (always bf16)
_LAUNCHERS = {
    "sla_bwd": {"sla_bwd_dq_launch": _DQ_ARGTYPES,
                "sla_bwd_dkv_launch": _DKV_ARGTYPES},
    "sla_bwd_tc": {"sla_bwd_dq_tc_launch": _DQ_ARGTYPES[:-2] + [_P],
                   "sla_bwd_dkv_tc_launch": _DKV_ARGTYPES[:-2] + [_P]},
}


@functools.cache
def _lib(name: str = "sla_bwd") -> ctypes.CDLL:
    """Build and load csrc/<name>.cu; each exports its launchers and
    `sla_bwd_error_string`."""
    from repro_torch.kernels import _build
    lib = _build.load(name)
    for fn, argtypes in _LAUNCHERS[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.sla_bwd_error_string.argtypes = [ctypes.c_int]
    lib.sla_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _route(kernel: str, q: torch.Tensor) -> bool:
    """True for the CUDA kernel, False for the CPU twin; raises for any
    other device."""
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"{kernel} runs on CUDA or CPU tensors, got "
                         f"{q.device}")
    return True


def sla_bwd_dq(lut, counts, q, k, v, do_s, lse, d_s, *, scale: float,
               causal: bool, block_q: int, block_kv: int) -> torch.Tensor:
    """dQ of the sparse component over the row LUT.

    Args:
      lut:    (BH, Tm, K) int32 critical kv-block ids per query block.
      counts: (BH, Tm) int32 live entries per row.
      q:      (BH, N, D) f32 or bf16; k, v (BH_kv, N, D) of q's dtype.
      do_s:   (BH, N, D) f32 cotangent of O^s.
      lse:    (BH, N) f32 forward row log-sum-exp; d_s (BH, N) f32
              rowsum(dO^s * O^s).

    Returns dq (BH, N, D) f32. On CUDA, bf16 q at 64 x 64 blocks and
    D <= 128 runs the tensor-core kernel (dO, P and dS rounded to bf16),
    everything else the f32-FMA kernel (`use_tensor_cores`); CPU tensors
    run the f32 twin.
    """
    kw = dict(scale=scale, causal=causal, block_q=block_q,
              block_kv=block_kv)
    args = (lut, counts, q, k, v, do_s, lse, d_s)
    if not _route("sla_bwd_dq", q):
        return sla_bwd_dq_plain(*args, **kw)
    return _launch_dq(*args, **kw)


def sla_bwd_dkv(col_lut, col_counts, q, k, v, do_s, lse, d_s, *,
                scale: float, causal: bool, block_q: int, block_kv: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dK, dV of the sparse component over the column LUT.

    Args as `sla_bwd_dq`, with col_lut (BH, Tn, W) int32 (critical query
    block ids per kv block) and col_counts (BH, Tn) int32.

    Returns (dk, dv), each (BH, N, D) f32 per query head: with GQA
    (BH_kv < BH) the caller sums each group. The route rule is
    `sla_bwd_dq`'s.
    """
    kw = dict(scale=scale, causal=causal, block_q=block_q,
              block_kv=block_kv)
    args = (col_lut, col_counts, q, k, v, do_s, lse, d_s)
    if not _route("sla_bwd_dkv", q):
        return sla_bwd_dkv_plain(*args, **kw)
    return _launch_dkv(*args, **kw)


def _check(kernel, lut, counts, q, k, v, do_s, lse, d_s, block_q,
           block_kv, lut_block):
    """Operand checks of both wrappers; `lut_block` is the block size
    the LUT's rows index (block_q for the row LUT, block_kv for the
    column LUT)."""
    ts = dict(lut=lut, counts=counts, q=q, k=k, v=v, do_s=do_s, lse=lse,
              d_s=d_s)
    check_operands(kernel, ts, ("do_s", "lse", "d_s"), ("lut", "counts"),
                   block_q, block_kv)
    bh, n, d = q.shape
    if k.shape[1] != n:
        raise ValueError(f"{kernel}: q and k/v must have one sequence "
                         f"length, got {n} and {k.shape[1]}")
    if do_s.shape != q.shape or lse.shape != (bh, n) \
            or d_s.shape != (bh, n):
        raise ValueError(f"{kernel}: do_s must be shaped like q, lse and "
                         f"d_s ({bh}, {n})")
    t = n // lut_block
    if lut.ndim != 3 or lut.shape[:2] != (bh, t) or lut.shape[2] < 1:
        raise ValueError(f"{kernel}: lut must be ({bh}, {t}, K>=1), got "
                         f"{tuple(lut.shape)}")
    if counts.shape != (bh, t):
        raise ValueError(f"{kernel}: counts must be ({bh}, {t}), got "
                         f"{tuple(counts.shape)}")


def _raise_on(err: int, kernel: str, lib):
    if err != 0:
        msg = lib.sla_bwd_error_string(err).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error "
                           f"{err} ({msg})")


def _launch_dq(lut, counts, q, k, v, do_s, lse, d_s, *, scale, causal,
               block_q, block_kv):
    global LAUNCHES_DQ
    _check("sla_bwd_dq", lut, counts, q, k, v, do_s, lse, d_s, block_q,
           block_kv, block_q)
    bh, n, d = q.shape
    if use_tensor_cores(q.dtype, block_q, block_kv, d):
        return _launch_dq_tc(lut, counts, q, k, v, do_s, lse, d_s,
                             scale=scale, causal=causal)
    lib = _lib()
    dq = torch.empty((bh, n, d), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sla_bwd_dq_launch(
            lut.data_ptr(), counts.data_ptr(), q.data_ptr(), k.data_ptr(),
            v.data_ptr(), do_s.data_ptr(), lse.data_ptr(), d_s.data_ptr(),
            dq.data_ptr(), bh, k.shape[0], n, d, lut.shape[-1], block_q,
            block_kv, float(scale), int(bool(causal)),
            int(q.dtype == torch.bfloat16), stream)
    _raise_on(err, "sla_bwd_dq", lib)
    LAUNCHES_DQ += 1
    return dq


def _launch_dkv(col_lut, col_counts, q, k, v, do_s, lse, d_s, *, scale,
                causal, block_q, block_kv):
    global LAUNCHES_DKV
    _check("sla_bwd_dkv", col_lut, col_counts, q, k, v, do_s, lse, d_s,
           block_q, block_kv, block_kv)
    bh, n, d = q.shape
    if use_tensor_cores(q.dtype, block_q, block_kv, d):
        return _launch_dkv_tc(col_lut, col_counts, q, k, v, do_s, lse, d_s,
                              scale=scale, causal=causal)
    lib = _lib()
    dk = torch.empty((bh, n, d), dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sla_bwd_dkv_launch(
            col_lut.data_ptr(), col_counts.data_ptr(), q.data_ptr(),
            k.data_ptr(), v.data_ptr(), do_s.data_ptr(), lse.data_ptr(),
            d_s.data_ptr(), dk.data_ptr(), dv.data_ptr(), bh, k.shape[0], n,
            d, col_lut.shape[-1], block_q, block_kv, float(scale),
            int(bool(causal)), int(q.dtype == torch.bfloat16), stream)
    _raise_on(err, "sla_bwd_dkv", lib)
    LAUNCHES_DKV += 1
    return dk, dv


def _tc_operands(kernel, q, k, v, do_s, lse, d_s):
    """q, k, v and dO as the tensor-core kernels read them: dO cast to
    bf16 once, all four zero-padded to `TC_HEAD_DIM`. Raises unless
    they, lse and d_s start on 16 bytes (the kernels copy 16-byte
    chunks)."""
    xs = [pad_head_dim(x) for x in (q, k, v, do_s.to(torch.bfloat16))]
    if any(x.data_ptr() % 16 for x in (*xs, lse, d_s)):
        raise ValueError(f"{kernel}: the tensor-core kernel needs q, k, v, "
                         f"do_s, lse and d_s 16-byte aligned")
    return xs


def _launch_dq_tc(lut, counts, q, k, v, do_s, lse, d_s, *, scale, causal):
    global LAUNCHES_DQ, TC_LAUNCHES_DQ
    lib = _lib("sla_bwd_tc")
    bh, n, d = q.shape
    qp, kp, vp, dop = _tc_operands("sla_bwd_dq", q, k, v, do_s, lse, d_s)
    dq = torch.empty((bh, n, TC_HEAD_DIM), dtype=torch.float32,
                     device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sla_bwd_dq_tc_launch(
            lut.data_ptr(), counts.data_ptr(), qp.data_ptr(), kp.data_ptr(),
            vp.data_ptr(), dop.data_ptr(), lse.data_ptr(), d_s.data_ptr(),
            dq.data_ptr(), bh, k.shape[0], n, TC_HEAD_DIM, lut.shape[-1],
            TC_BLOCK, TC_BLOCK, float(scale), int(bool(causal)), stream)
    _raise_on(err, "sla_bwd_dq tensor-core", lib)
    LAUNCHES_DQ += 1
    TC_LAUNCHES_DQ += 1
    return dq if d == TC_HEAD_DIM else dq[..., :d].contiguous()


def _launch_dkv_tc(col_lut, col_counts, q, k, v, do_s, lse, d_s, *, scale,
                   causal):
    global LAUNCHES_DKV, TC_LAUNCHES_DKV
    lib = _lib("sla_bwd_tc")
    bh, n, d = q.shape
    qp, kp, vp, dop = _tc_operands("sla_bwd_dkv", q, k, v, do_s, lse,
                                   d_s)
    dk = torch.empty((bh, n, TC_HEAD_DIM), dtype=torch.float32,
                     device=q.device)
    dv = torch.empty_like(dk)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sla_bwd_dkv_tc_launch(
            col_lut.data_ptr(), col_counts.data_ptr(), qp.data_ptr(),
            kp.data_ptr(), vp.data_ptr(), dop.data_ptr(), lse.data_ptr(),
            d_s.data_ptr(), dk.data_ptr(), dv.data_ptr(), bh, k.shape[0], n,
            TC_HEAD_DIM, col_lut.shape[-1], TC_BLOCK, TC_BLOCK,
            float(scale), int(bool(causal)), stream)
    _raise_on(err, "sla_bwd_dkv tensor-core", lib)
    LAUNCHES_DKV += 1
    TC_LAUNCHES_DKV += 1
    if d != TC_HEAD_DIM:
        dk, dv = dk[..., :d].contiguous(), dv[..., :d].contiguous()
    return dk, dv


def _rounded(x, mma_dtype):
    """x rounded to `mma_dtype` and back to f32 (x itself for None)."""
    return x if mma_dtype is None else x.to(mma_dtype).float()


def _recompute(qi, kj, vj, doi, lse_i, ds_i, rows, cols, scale, causal):
    """P and dS for gathered tiles: qi/doi (..., bq, D), kj/vj (..., bkv,
    D), lse_i/ds_i (..., bq); rows (..., bq) and cols (..., bkv) absolute
    ids for the causal mask."""
    sij = torch.matmul(qi, kj.transpose(-1, -2)) * scale
    if causal:
        ok = rows[..., :, None] >= cols[..., None, :]
        sij = torch.where(ok, sij, torch.full_like(sij, NEG_INF))
    p = torch.exp(sij - lse_i[..., None])
    dp = torch.matmul(doi, vj.transpose(-1, -2))
    return p, p * (dp - ds_i[..., None]) * scale


def _tiles(q, k, v, do_s, lse, d_s, block_q, block_kv):
    """f32 block views: q/dO/lse/D by query block (BH, Tm, bq, ...), k/v
    by kv block (BH_kv, Tn, bkv, D)."""
    bh, n, d = q.shape
    tm, tn = n // block_q, n // block_kv
    return (q.float().reshape(bh, tm, block_q, d),
            k.float().reshape(k.shape[0], tn, block_kv, d),
            v.float().reshape(v.shape[0], tn, block_kv, d),
            do_s.float().reshape(bh, tm, block_q, d),
            lse.float().reshape(bh, tm, block_q),
            d_s.float().reshape(bh, tm, block_q))


def sla_bwd_dq_plain(lut, counts, q, k, v, do_s, lse, d_s, *, scale: float,
                     causal: bool, block_q: int, block_kv: int,
                     mma_dtype=None) -> torch.Tensor:
    """Plain-PyTorch twin of the dQ kernel: the same walk over row-LUT
    slots s, one update per slot for every (bh, query block) at once,
    slots s >= counts left out. Same arguments and output as
    `sla_bwd_dq`; all arithmetic in f32. `mma_dtype=torch.bfloat16`
    rounds dO and dS to bf16 before their products, as the tensor-core
    kernel does."""
    bh, n, d = q.shape
    qb, kb, vb, dob, lseb, dsb = _tiles(q, k, v, do_s, lse, d_s, block_q,
                                        block_kv)
    dob = _rounded(dob, mma_dtype)
    dev = q.device
    tm = qb.shape[1]
    kvh = (torch.arange(bh, device=dev) // (bh // k.shape[0]))[:, None]
    rows = (torch.arange(tm, device=dev)[:, None] * block_q
            + torch.arange(block_q, device=dev))  # (Tm, bq)
    dq = torch.zeros_like(qb)
    for s in range(lut.shape[-1]):
        live = (s < counts)[..., None, None]  # (BH, Tm, 1, 1)
        j = lut[:, :, s].long()  # (BH, Tm)
        kj, vj = kb[kvh, j], vb[kvh, j]  # (BH, Tm, bkv, D)
        cols = j[..., None] * block_kv + torch.arange(block_kv, device=dev)
        _, ds = _recompute(qb, kj, vj, dob, lseb, dsb, rows, cols, scale,
                           causal)
        dq = torch.where(live, dq + torch.matmul(_rounded(ds, mma_dtype),
                                                 kj), dq)
    return dq.reshape(bh, n, d)


def sla_bwd_dkv_plain(col_lut, col_counts, q, k, v, do_s, lse, d_s, *,
                      scale: float, causal: bool, block_q: int,
                      block_kv: int, mma_dtype=None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain-PyTorch twin of the dK/dV kernel: the same walk over
    column-LUT slots c, one update per slot for every (bh, kv block) at
    once, slots c >= col_counts left out. Same arguments and outputs as
    `sla_bwd_dkv`; all arithmetic in f32. `mma_dtype=torch.bfloat16`
    rounds dO, P and dS to bf16 before their products, as the
    tensor-core kernel does."""
    bh, n, d = q.shape
    qb, kb, vb, dob, lseb, dsb = _tiles(q, k, v, do_s, lse, d_s, block_q,
                                        block_kv)
    dob = _rounded(dob, mma_dtype)
    dev = q.device
    tn = kb.shape[1]
    kvh = torch.arange(bh, device=dev) // (bh // k.shape[0])
    kj, vj = kb[kvh], vb[kvh]  # (BH, Tn, bkv, D): each q head's kv head
    hh = torch.arange(bh, device=dev)[:, None]
    cols = (torch.arange(tn, device=dev)[:, None] * block_kv
            + torch.arange(block_kv, device=dev))  # (Tn, bkv)
    dk, dv = torch.zeros_like(kj), torch.zeros_like(vj)
    for c in range(col_lut.shape[-1]):
        live = (c < col_counts)[..., None, None]  # (BH, Tn, 1, 1)
        i = col_lut[:, :, c].long()  # (BH, Tn)
        qi, doi = qb[hh, i], dob[hh, i]  # (BH, Tn, bq, D)
        rows = i[..., None] * block_q + torch.arange(block_q, device=dev)
        p, ds = _recompute(qi, kj, vj, doi, lseb[hh, i], dsb[hh, i], rows,
                           cols, scale, causal)
        p, ds = _rounded(p, mma_dtype), _rounded(ds, mma_dtype)
        dv = torch.where(live, dv + torch.matmul(p.transpose(-1, -2), doi),
                         dv)
        dk = torch.where(live, dk + torch.matmul(ds.transpose(-1, -2), qi),
                         dk)
    return dk.reshape(bh, n, d), dv.reshape(bh, n, d)
