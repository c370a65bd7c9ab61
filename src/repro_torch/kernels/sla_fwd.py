"""Fused SLA forward: the CUDA kernels `csrc/sla_fwd.cu` and
`csrc/sla_fwd_tc.cu`, their plain twin, the route rule they share with the
backward, and their launch counters.

Counterpart of the Pallas TPU kernel `repro.kernels.sla_fwd._fwd_kernel`.
For each (batch*head, query block i) it runs online softmax over the
`counts[i]` critical KV blocks named by `lut[i]` and merges the linear
branch O^l = phi(Q_i) H_i / phi(Q_i) Z_i (zero where den <= 1e-6).

`sla_fwd` launches a kernel for CUDA tensors and runs `sla_fwd_plain`
(plain PyTorch walking the same LUT loop) only for CPU tensors: a CUDA
tensor gets a kernel or an exception, never the plain version. Which
kernel is a rule on dtype and shape (`use_tensor_cores`, which the
backward's wrappers import too, so a training step never mixes routes),
not a fallback:

  * bf16 q, k, v at 64 x 64 blocks and head dims up to 128: the
    tensor-core kernel of `sla_fwd_tc.cu` (wgmma). Its precision is
    FlashAttention's: P is rounded to bf16 before P V; every sum, m, l,
    lse and the whole linear branch are f32. Narrower heads zero-pad q, k
    and v to `TC_HEAD_DIM` (zero columns leave S unchanged); qp, hi, zi
    and the outputs keep their own D.
  * everything else (f32, other blocks): the f32-FMA kernel of
    `sla_fwd.cu`, every product in f32 from the same inputs.

A failed build or launch raises; nothing reroutes. With
`mma_dtype=torch.bfloat16` the twin rounds P where the tensor-core kernel
does, the yardstick of that route's rounding. `LAUNCHES` counts kernel
launches of either route and nothing else, `TC_LAUNCHES` those of the
tensor-core route.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

NEG_INF = -1e30
EPS = 1e-6
MAX_HEAD_DIM = 128
MAX_BLOCK = 64

LAUNCHES = 0  # kernel launches in this process (plain-twin calls excluded)
TC_LAUNCHES = 0  # of which on the tensor-core route
TC_BLOCK = 64      # the tensor-core kernels' block_q == block_kv
TC_HEAD_DIM = 128  # the head dim they are built for (narrower is padded)

_I, _F, _P = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
# lut, counts, base, q, k, v, qp, hi, zi, o_s, o_l, lse; bh_q, bh_kv, nq,
# nkv, d, tm, k_sel, block_q, block_kv; scale; causal, is_bf16; stream. The
# tensor-core kernel takes the same arguments without is_bf16.
_ARGTYPES = [_P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
             _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _P]
_TC_ARGTYPES = _ARGTYPES[:-2] + [_P]


@functools.cache
def _lib(name: str = "sla_fwd") -> ctypes.CDLL:
    """Build and load csrc/<name>.cu; each exports `<name>_launch` and
    `<name>_error_string`."""
    from repro_torch.kernels import _build
    lib = _build.load(name)
    launch = getattr(lib, f"{name}_launch")
    launch.argtypes = _TC_ARGTYPES if name == "sla_fwd_tc" else _ARGTYPES
    launch.restype = ctypes.c_int
    errs = getattr(lib, f"{name}_error_string")
    errs.argtypes = [ctypes.c_int]
    errs.restype = ctypes.c_char_p
    return lib


def use_tensor_cores(dtype: torch.dtype, block_q: int, block_kv: int,
                     d: int) -> bool:
    """The route rule of a CUDA call, for the forward and the backward: bf16
    operands at 64 x 64 blocks and head dims up to `TC_HEAD_DIM` take the
    tensor-core kernels, every other call the f32-FMA kernels."""
    return (dtype == torch.bfloat16 and block_q == TC_BLOCK
            and block_kv == TC_BLOCK and d <= TC_HEAD_DIM)


def pad_head_dim(x: torch.Tensor) -> torch.Tensor:
    """Zero-pad the last dim to `TC_HEAD_DIM` (x itself when it is that
    wide already)."""
    d = x.shape[-1]
    if d == TC_HEAD_DIM:
        return x
    return torch.nn.functional.pad(x, (0, TC_HEAD_DIM - d)).contiguous()


def sla_fwd(lut, counts, q, k, v, qp, hi, zi, *, scale: float,
            causal: bool, block_q: int, block_kv: int, base: int = 0
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run the fused forward.

    Args:
      lut:    (BH, Tm, K) int32 critical block indices (padded).
      counts: (BH, Tm) int32 live entries per row.
      q:      (BH, Nq, D) f32 or bf16; qp (BH, Nq, D) f32 = phi(q).
      k, v:   (BH_kv, N, D), same dtype as q, with BH % BH_kv == 0.
      hi:     (BH, Tm, D, D) f32 aggregated marginal H per row block.
      zi:     (BH, Tm, D) f32 aggregated marginal Z per row block.
      base:   absolute block id of query row block 0 (causal masking of
              a span of query rows against the full KV).

    Returns (o_s (BH,Nq,D) f32, o_l (BH,Nq,D) f32, lse (BH,Nq) f32). On
    CUDA, bf16 q at 64 x 64 blocks and D <= 128 runs the tensor-core
    kernel (P rounded to bf16), everything else the f32-FMA kernel
    (`use_tensor_cores`); CPU tensors run the f32 twin.
    """
    kw = dict(scale=scale, causal=causal, block_q=block_q,
              block_kv=block_kv, base=base)
    if q.device.type == "cpu":
        return sla_fwd_plain(lut, counts, q, k, v, qp, hi, zi, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"sla_fwd runs on CUDA or CPU tensors, got "
                         f"{q.device}")
    return _launch(lut, counts, q, k, v, qp, hi, zi, **kw)


def check_operands(kernel: str, ts: dict, f32: Tuple[str, ...],
                   i32: Tuple[str, ...], block_q: int, block_kv: int,
                   q_f32: bool = False):
    """The checks every SLA kernel wrapper shares: one device, contiguity,
    q/k/v in one of f32/bf16, the named f32 and int32 operands, q
    (BH, Nq, D) against k/v (BH_kv, N, D), and the head dims and blocks
    the kernels take. `ts` maps operand names to tensors and holds q, k
    and v. With `q_f32` q must be f32 and k/v share either dtype (the
    decode kernel); otherwise q, k and v share one. Raises TypeError or
    ValueError naming `kernel`."""
    q, k, v = ts["q"], ts["k"], ts["v"]
    for name, t in ts.items():
        if t.device != q.device:
            raise ValueError(f"{kernel}: {name} is on {t.device}, q on "
                             f"{q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")
    lead = k if q_f32 else q
    if lead.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{kernel}: {'k' if q_f32 else 'q'} must be "
                        f"float32 or bfloat16, got {lead.dtype}")
    if q_f32 and q.dtype != torch.float32:
        raise TypeError(f"{kernel}: q must be float32, got {q.dtype}")
    if k.dtype != lead.dtype or v.dtype != lead.dtype:
        raise TypeError(f"{kernel}: {'k and v' if q_f32 else 'q, k and v'}"
                        " must share one dtype")
    for name in f32:
        if ts[name].dtype != torch.float32:
            raise TypeError(f"{kernel}: {name} must be float32")
    for name in i32:
        if ts[name].dtype != torch.int32:
            raise TypeError(f"{kernel}: {name} must be int32")
    if q.ndim != 3 or k.ndim != 3 or v.shape != k.shape:
        raise ValueError(f"{kernel}: q must be (BH, Nq, D) and k/v "
                         "(BH_kv, N, D)")
    bh, nq, d = q.shape
    bh_kv, nkv = k.shape[0], k.shape[1]
    if k.shape[2] != d or bh % bh_kv:
        raise ValueError(f"{kernel}: k {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if d > MAX_HEAD_DIM or d % 4:
        raise ValueError(f"{kernel} kernel takes head dims <= "
                         f"{MAX_HEAD_DIM} that are multiples of 4, got {d}")
    if not (1 <= block_q <= MAX_BLOCK and 1 <= block_kv <= MAX_BLOCK):
        raise ValueError(f"{kernel} kernel takes blocks of 1..{MAX_BLOCK}, "
                         f"got {block_q} x {block_kv}")
    if nq % block_q or nkv % block_kv:
        raise ValueError(f"{kernel}: sequence lengths must be whole blocks")


def _check(lut, counts, q, k, v, qp, hi, zi, block_q, block_kv):
    ts = dict(lut=lut, counts=counts, q=q, k=k, v=v, qp=qp, hi=hi, zi=zi)
    check_operands("sla_fwd", ts, ("qp", "hi", "zi"), ("lut", "counts"),
                   block_q, block_kv)
    if qp.shape != q.shape:
        raise ValueError("sla_fwd: qp must be shaped like q")
    bh, nq, d = q.shape
    tm = nq // block_q
    if lut.ndim != 3 or lut.shape[:2] != (bh, tm) or lut.shape[2] < 1:
        raise ValueError(f"sla_fwd: lut must be ({bh}, {tm}, K>=1), got "
                         f"{tuple(lut.shape)}")
    if counts.shape != (bh, tm) or hi.shape != (bh, tm, d, d) \
            or zi.shape != (bh, tm, d):
        raise ValueError("sla_fwd: counts/hi/zi shapes do not match q")


def _launch(lut, counts, q, k, v, qp, hi, zi, *, scale, causal, block_q,
            block_kv, base):
    global LAUNCHES, TC_LAUNCHES
    _check(lut, counts, q, k, v, qp, hi, zi, block_q, block_kv)
    bh, nq, d = q.shape
    bh_kv, nkv = k.shape[0], k.shape[1]
    tc = use_tensor_cores(q.dtype, block_q, block_kv, d)
    name = "sla_fwd_tc" if tc else "sla_fwd"
    lib = _lib(name)
    flags = []  # the f32-FMA kernel's is_bf16
    if tc:
        q, k, v = (pad_head_dim(x) for x in (q, k, v))
        if any(x.data_ptr() % 16 for x in (q, k, v, qp, hi, zi)):
            raise ValueError("sla_fwd: the tensor-core kernel needs q, k, v,"
                             " qp, hi and zi 16-byte aligned")
    else:
        flags = [int(q.dtype == torch.bfloat16)]
    o_s = torch.empty((bh, nq, d), dtype=torch.float32, device=q.device)
    o_l = torch.empty_like(o_s)
    lse = torch.empty((bh, nq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, f"{name}_launch")(
            lut.data_ptr(), counts.data_ptr(), int(base), q.data_ptr(),
            k.data_ptr(), v.data_ptr(), qp.data_ptr(), hi.data_ptr(),
            zi.data_ptr(), o_s.data_ptr(), o_l.data_ptr(), lse.data_ptr(),
            bh, bh_kv, nq, nkv, d, nq // block_q, lut.shape[-1], block_q,
            block_kv, float(scale), int(bool(causal)), *flags, stream)
    if err != 0:
        msg = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"({msg})")
    LAUNCHES += 1
    TC_LAUNCHES += int(tc)
    return o_s, o_l, lse


def sla_fwd_plain(lut, counts, q, k, v, qp, hi, zi, *, scale: float,
                  causal: bool, block_q: int, block_kv: int, base: int = 0,
                  mma_dtype=None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain-PyTorch twin of the kernels: the same LUT walk over slots s,
    one online-softmax update per slot for every (bh, row block) at once,
    with slots s >= counts left out. Same arguments and outputs as
    `sla_fwd`; all arithmetic in f32. `mma_dtype=torch.bfloat16` rounds P
    (and only P) to bf16 before P V, as the tensor-core kernel does; l
    still sums the unrounded P."""
    bh, nq, d = q.shape
    bh_kv, nkv = k.shape[0], k.shape[1]
    group = bh // bh_kv
    tm, bq, bkv = nq // block_q, block_q, block_kv
    dev = q.device
    qb = q.float().reshape(bh, tm, bq, d)
    kb = k.float().reshape(bh_kv, nkv // bkv, bkv, d)
    vb = v.float().reshape(bh_kv, nkv // bkv, bkv, d)
    kvh = (torch.arange(bh, device=dev) // group)[:, None]
    rows = ((base + torch.arange(tm, device=dev))[:, None] * bq
            + torch.arange(bq, device=dev))  # (Tm, bq) absolute rows
    acc = torch.zeros((bh, tm, bq, d), dtype=torch.float32, device=dev)
    m = torch.full((bh, tm, bq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((bh, tm, bq), dtype=torch.float32, device=dev)
    for s in range(lut.shape[-1]):
        live = (s < counts)[..., None]  # (BH, Tm, 1)
        j = lut[:, :, s].long()  # (BH, Tm)
        kj, vj = kb[kvh, j], vb[kvh, j]  # (BH, Tm, bkv, D)
        sij = torch.matmul(qb, kj.transpose(-1, -2)) * scale
        if causal:
            cols = j[..., None] * bkv + torch.arange(bkv, device=dev)
            ok = rows[None, :, :, None] >= cols[:, :, None, :]
            sij = torch.where(ok, sij, torch.full_like(sij, NEG_INF))
        m_new = torch.maximum(m, sij.amax(dim=-1))
        p = torch.exp(sij - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l_new = l * alpha + p.sum(dim=-1)
        p_mma = p if mma_dtype is None else p.to(mma_dtype).float()
        acc_new = acc * alpha[..., None] + torch.matmul(p_mma, vj)
        m = torch.where(live, m_new, m)
        l = torch.where(live, l_new, l)
        acc = torch.where(live[..., None], acc_new, acc)
    o_s = acc / l[..., None]
    lse = m + torch.log(l)
    qpb = qp.float().reshape(bh, tm, bq, d)
    num = torch.matmul(qpb, hi)
    den = torch.matmul(qpb, zi[..., None])
    live = den > EPS
    o_l = torch.where(live, num / torch.where(live, den, torch.ones_like(den)),
                      torch.zeros_like(num))
    return (o_s.reshape(bh, nq, d), o_l.reshape(bh, nq, d),
            lse.reshape(bh, nq))
