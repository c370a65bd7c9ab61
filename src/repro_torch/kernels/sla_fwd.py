"""Fused SLA forward: the CUDA kernels `csrc/sla_fwd.cu`,
`csrc/sla_fwd_tc.cu` and `csrc/sla_fwd_split.cu`, their plain twin, the
route rules, and their launch counters.

Counterpart of the Pallas TPU kernel `repro.kernels.sla_fwd._fwd_kernel`.
For each (batch*head, query block i) it runs online softmax over the
`counts[i]` critical KV blocks named by `lut[i]` and merges the linear
branch O^l = phi(Q_i) H_i / phi(Q_i) Z_i (zero where den <= 1e-6).

`sla_fwd` launches a kernel for CUDA tensors and runs `sla_fwd_plain`
(plain PyTorch walking the same LUT loop) only for CPU tensors: a CUDA
tensor gets a kernel or an exception, never the plain version. Which
kernel is a rule on dtype and shape (`forward_route`), not a fallback:

  * bf16 q, k, v at 64 x 64 blocks and head dims up to 128: the
    tensor-core kernel of `sla_fwd_tc.cu` (wgmma; `use_tensor_cores`, the
    rule the backward's wrappers import too, so a bf16 training step never
    mixes routes). Its precision is FlashAttention's: P is rounded to bf16
    before P V; every sum, m, l, lse and the whole linear branch are f32.
  * f32 q, k, v at those blocks and head dims (`use_split`, a rule of the
    forward alone: f32 DiT serving): the split kernel of
    `sla_fwd_split.cu`, on the tensor cores with f32 accuracy. Each f32
    operand of Q K^T and P V is cut into three bf16 parts
    (`split_bf16x3`, exact), and each tile product sums six part products
    in f32; K and V are cut once a call by a pre-pass kernel
    (`split_kv_planes`). A step that trains in f32 then runs this forward
    and the f32-FMA backward: both are f32-accurate, so this is not the
    bf16-rounding mismatch the shared rule exists to prevent.
  * everything else (blocks other than 64 x 64): the f32-FMA kernel of
    `sla_fwd.cu`, every product in f32 from the same inputs.

Narrower heads on the tensor-core routes zero-pad q, k and v to
`TC_HEAD_DIM` (zero columns leave S unchanged; the split route pads in
its pre-pass and its Q loads); qp, hi, zi and the outputs keep their own
D. A failed build or launch raises; nothing reroutes. With
`mma_dtype=torch.bfloat16` the twin rounds P where the tensor-core kernel
does, and with `mma_dtype="bf16x3"` it cuts and sums the products as the
split kernel does: the yardsticks of those routes' arithmetic.
`LAUNCHES` counts kernel launches of the forward on any route and nothing
else, `TC_LAUNCHES` those of the tensor-core route, `SPLIT_LAUNCHES`
those of the split route, `PLANES_LAUNCHES` those of its pre-pass.
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
SPLIT_LAUNCHES = 0  # of which on the split route
PLANES_LAUNCHES = 0  # launches of the split route's K/V pre-pass
TC_BLOCK = 64      # the tensor-core kernels' block_q == block_kv
TC_HEAD_DIM = 128  # the head dim they are built for (narrower is padded)
SPLIT_PARTS = 3    # bf16 parts of each f32 operand on the split route
# the part products the split route sums, smallest first (x2y0, x1y1,
# x0y2, x1y0, x0y1, x0y0): the three below 2^-21 |x||y| are dropped
SPLIT_PAIRS = ((2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0))
SPLIT_PRODUCTS = len(SPLIT_PAIRS)
ROUTES = {"fma": "sla_fwd", "tc": "sla_fwd_tc", "split": "sla_fwd_split"}

_I, _F, _P = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
# lut, counts, base, q, k, v, qp, hi, zi, o_s, o_l, lse; bh_q, bh_kv, nq,
# nkv, d, tm, k_sel, block_q, block_kv; scale; causal, is_bf16; stream. The
# tensor-core kernel takes the same arguments without is_bf16, the split
# kernel too, with k and v's planes for k and v.
_ARGTYPES = [_P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
             _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _P]
_TC_ARGTYPES = _ARGTYPES[:-2] + [_P]


@functools.cache
def _lib(name: str = "sla_fwd") -> ctypes.CDLL:
    """Build and load csrc/<name>.cu; each exports `<name>_launch` and
    `<name>_error_string`, the split source also its pre-pass
    (`sla_fwd_split_planes_launch`: k, v, k3, v3, rows, d, stream) and
    `sla_fwd_split_ctas_per_sm`."""
    from repro_torch.kernels import _build
    lib = _build.load(name)
    launch = getattr(lib, f"{name}_launch")
    launch.argtypes = _ARGTYPES if name == "sla_fwd" else _TC_ARGTYPES
    launch.restype = ctypes.c_int
    errs = getattr(lib, f"{name}_error_string")
    errs.argtypes = [ctypes.c_int]
    errs.restype = ctypes.c_char_p
    if name == "sla_fwd_split":
        lib.sla_fwd_split_planes_launch.argtypes = [_P, _P, _P, _P, _I, _I,
                                                    _P]
        lib.sla_fwd_split_planes_launch.restype = ctypes.c_int
        lib.sla_fwd_split_ctas_per_sm.argtypes = []
        lib.sla_fwd_split_ctas_per_sm.restype = ctypes.c_int
    return lib


def use_tensor_cores(dtype: torch.dtype, block_q: int, block_kv: int,
                     d: int) -> bool:
    """The bf16 route rule of a CUDA call, for the forward and the
    backward: bf16 operands at 64 x 64 blocks and head dims up to
    `TC_HEAD_DIM` take the tensor-core kernels (the rounding of P, and of
    dO, P and dS, is then the same in both directions)."""
    return (dtype == torch.bfloat16 and block_q == TC_BLOCK
            and block_kv == TC_BLOCK and d <= TC_HEAD_DIM)


def use_split(dtype: torch.dtype, block_q: int, block_kv: int,
              d: int) -> bool:
    """The forward's f32 route rule beside `use_tensor_cores`: f32 operands
    at 64 x 64 blocks and head dims up to `TC_HEAD_DIM` take the split
    kernel (tensor cores, f32-accurate products). The backward keeps its
    f32-FMA route for them; both directions are then f32-accurate."""
    return (dtype == torch.float32 and block_q == TC_BLOCK
            and block_kv == TC_BLOCK and d <= TC_HEAD_DIM)


def forward_route(dtype: torch.dtype, block_q: int, block_kv: int,
                  d: int) -> str:
    """The forward kernel a CUDA call takes: "tc" (`use_tensor_cores`),
    "split" (`use_split`) or "fma" (`sla_fwd.cu`, every other call)."""
    if use_tensor_cores(dtype, block_q, block_kv, d):
        return "tc"
    if use_split(dtype, block_q, block_kv, d):
        return "split"
    return "fma"


def split_bf16x3(x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The split route's cut of f32 `x` into `SPLIT_PARTS` parts, each an
    f32 tensor of values exact in bf16: part 0 keeps the upper 16 bits of
    x (bf16 by truncation, which never overflows), part 1 those of x -
    part 0, part 2 those of what is left. The parts sum to x exactly when
    x's lowest set bit is at or above 2^-133 (bf16's denormal step), and
    within 2^-133 otherwise; the kernels cut bit for bit alike."""
    parts, rest = [], x.float()
    for _ in range(SPLIT_PARTS):
        part = (rest.view(torch.int32) & -65536).view(torch.float32)
        parts.append(part)
        rest = rest - part
    return tuple(parts)


def _split_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the split kernel computes it: the products of the parts
    named by `SPLIT_PAIRS`, summed in that order in f32."""
    pa, pb = split_bf16x3(a), split_bf16x3(b)
    out = None
    for i, j in SPLIT_PAIRS:
        prod = torch.matmul(pa[i], pb[j])
        out = prod if out is None else out + prod
    return out


def pad_head_dim(x: torch.Tensor) -> torch.Tensor:
    """Zero-pad the last dim to `TC_HEAD_DIM` (x itself when it is that
    wide already)."""
    d = x.shape[-1]
    if d == TC_HEAD_DIM:
        return x
    return torch.nn.functional.pad(x, (0, TC_HEAD_DIM - d)).contiguous()


def split_kv_planes(k: torch.Tensor, v: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The split route's pre-pass: f32 k and v (BH_kv, N, D) cut into
    their `SPLIT_PARTS` bf16 parts (`split_bf16x3`), zero-padded to
    `TC_HEAD_DIM`: (k3, v3), each (3, BH_kv, N, TC_HEAD_DIM) bf16. On CUDA
    the kernel `split_kv_kernel` of `sla_fwd_split.cu` (counted in
    `PLANES_LAUNCHES`); CPU tensors run `split_kv_planes_plain`."""
    global PLANES_LAUNCHES
    if k.device.type == "cpu":
        return split_kv_planes_plain(k, v)
    if k.device.type != "cuda":
        raise ValueError(f"split_kv_planes runs on CUDA or CPU tensors, got "
                         f"{k.device}")
    if k.dtype != torch.float32 or v.dtype != torch.float32:
        raise TypeError("split_kv_planes: k and v must be float32")
    if k.ndim != 3 or v.shape != k.shape or v.device != k.device:
        raise ValueError("split_kv_planes: k and v must be (BH_kv, N, D) "
                         "on one device")
    if not (k.is_contiguous() and v.is_contiguous()):
        raise ValueError("split_kv_planes: k and v must be contiguous")
    d = k.shape[-1]
    if d > TC_HEAD_DIM or d % 4:
        raise ValueError(f"split_kv_planes takes head dims <= {TC_HEAD_DIM} "
                         f"that are multiples of 4, got {d}")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("split_kv_planes: k and v must be 16-byte aligned")
    rows = k.shape[0] * k.shape[1]
    k3, v3 = (torch.empty((SPLIT_PARTS, *k.shape[:2], TC_HEAD_DIM),
                          dtype=torch.bfloat16, device=k.device)
              for _ in range(2))
    lib = _lib("sla_fwd_split")
    with torch.cuda.device(k.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sla_fwd_split_planes_launch(
            k.data_ptr(), v.data_ptr(), k3.data_ptr(), v3.data_ptr(), rows, d,
            stream)
    if err != 0:
        msg = lib.sla_fwd_split_error_string(err).decode()
        raise RuntimeError(f"split_kv_kernel launch failed: CUDA error {err} "
                           f"({msg})")
    PLANES_LAUNCHES += 1
    return k3, v3


def split_kv_planes_plain(k: torch.Tensor, v: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain-PyTorch twin of `split_kv_planes` (bit for bit)."""
    return tuple(torch.stack([pad_head_dim(p) for p in split_bf16x3(x)])
                 .to(torch.bfloat16) for x in (k, v))


def split_ctas_per_sm() -> int:
    """CTAs of the split kernel resident on one SM of the current card
    (its design wants 2); raises if the query fails."""
    n = _lib("sla_fwd_split").sla_fwd_split_ctas_per_sm()
    if n < 0:
        raise RuntimeError(f"occupancy query failed: CUDA error {-n}")
    return n


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
    CUDA, q at 64 x 64 blocks and D <= 128 runs the tensor-core kernel if
    bf16 (P rounded to bf16) and the split kernel if f32 (f32-accurate
    products), everything else the f32-FMA kernel (`forward_route`); CPU
    tensors run the f32 twin.
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
            block_kv, base, route=None):
    """Launch the forward kernel of `route` ("fma", "tc" or "split"; None:
    `forward_route`'s choice). A route forced past the rule must still
    take the call's dtype and shape, or ValueError."""
    global LAUNCHES, TC_LAUNCHES, SPLIT_LAUNCHES
    _check(lut, counts, q, k, v, qp, hi, zi, block_q, block_kv)
    bh, nq, d = q.shape
    bh_kv, nkv = k.shape[0], k.shape[1]
    rule = forward_route(q.dtype, block_q, block_kv, d)
    route = rule if route is None else route
    if route not in ROUTES or (route != "fma" and route != rule):
        raise ValueError(f"sla_fwd: route {route!r} does not take "
                         f"{q.dtype} at {block_q} x {block_kv} blocks, D {d}")
    name = ROUTES[route]
    lib = _lib(name)
    flags = []  # the f32-FMA kernel's is_bf16
    if route == "fma":
        flags = [int(q.dtype == torch.bfloat16)]
    elif any(x.data_ptr() % 16 for x in (q, k, v, qp, hi, zi)):
        raise ValueError(f"sla_fwd: the {name} kernel needs q, k, v, qp, hi"
                         " and zi 16-byte aligned")
    elif route == "tc":
        q, k, v = (pad_head_dim(x) for x in (q, k, v))
    else:  # split: K and V cut into planes (padded there), q cut in-kernel
        k, v = split_kv_planes(k, v)
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
    TC_LAUNCHES += int(route == "tc")
    SPLIT_LAUNCHES += int(route == "split")
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
    still sums the unrounded P. `mma_dtype="bf16x3"` computes Q K^T and
    P V as the split kernel does (`_split_matmul`: three bf16 parts of
    each operand, six part products summed in f32); l sums the uncut P."""
    if mma_dtype not in (None, torch.bfloat16, "bf16x3"):
        raise ValueError(f"mma_dtype must be None, torch.bfloat16 or "
                         f"'bf16x3', got {mma_dtype!r}")
    split = mma_dtype == "bf16x3"
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
        kt = kj.transpose(-1, -2)
        sij = (_split_matmul(qb, kt) if split else torch.matmul(qb, kt)) \
            * scale
        if causal:
            cols = j[..., None] * bkv + torch.arange(bkv, device=dev)
            ok = rows[None, :, :, None] >= cols[:, :, None, :]
            sij = torch.where(ok, sij, torch.full_like(sij, NEG_INF))
        m_new = torch.maximum(m, sij.amax(dim=-1))
        p = torch.exp(sij - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l_new = l * alpha + p.sum(dim=-1)
        if split:
            pv = _split_matmul(p, vj)
        else:
            p_mma = p if mma_dtype is None else p.to(mma_dtype).float()
            pv = torch.matmul(p_mma, vj)
        acc_new = acc * alpha[..., None] + pv
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
