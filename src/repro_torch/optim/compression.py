"""Error-feedback gradient compression, as the reference's
`repro.optim.compression`.

int8 block quantization with error feedback (EF-SGD style): each
gradient plus its carried error is cut into blocks of `BLOCK` values
(zero-padded at the end), each block coded as int8 with one f32 scale
max|x| / 127 (an all-zero block is divided by 1.0 and keeps scale 0),
rounding half to even as `jnp.round` does; the residual
e' = (g + e) - deq(q) is carried to the next step, so the compression
error enters the optimizer path instead of being lost. Gradients and
errors are dicts of tensors keyed by parameter name, and a block never
crosses two tensors. The reference blocks each pytree leaf, and its
stacked leaves hold every layer of a stack, so where a layer's size is
not a multiple of `BLOCK` one of its blocks there also holds the next
layer's first values; the port pads each layer's tensor instead
(ROADMAP.md queue 3 names the leaves). On the same tensors the codes and
scales are bitwise the reference's. These are plain tensor ops (XLA ops
in the reference too, not a Pallas kernel).
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple

import torch

BLOCK = 128


def _pad_to(x: torch.Tensor, m: int) -> torch.Tensor:
    flat = x.reshape(-1)
    return torch.nn.functional.pad(flat, (0, (-flat.shape[0]) % m))


def quantize(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """g (any shape, f32/bf16) -> (int8 codes (Nb, BLOCK), f32 scales
    (Nb,))."""
    flat = _pad_to(g.float(), BLOCK).reshape(-1, BLOCK)
    scale = flat.abs().amax(dim=1) / 127.0
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    codes = torch.clamp(torch.round(flat / safe[:, None]), -127, 127) \
        .to(torch.int8)
    return codes, scale


def dequantize(codes: torch.Tensor, scale: torch.Tensor, shape,
               dtype=torch.float32) -> torch.Tensor:
    flat = codes.float() * scale[:, None]
    n = math.prod(shape)
    return flat.reshape(-1)[:n].reshape(shape).to(dtype)


def ef_init(grads: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Zero f32 errors shaped like each gradient (or parameter)."""
    return {n: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            for n, g in grads.items()}


def ef_compress_decompress(grads: Mapping[str, torch.Tensor],
                           error: Mapping[str, torch.Tensor]
                           ) -> Tuple[dict, dict, dict]:
    """Simulate the compressed wire format locally: the update then runs
    on the dequantized gradients. Returns (grads_hat, new_error, stats)
    with stats {"compression_x": f32 bits / wire bits}."""
    bits_full = bits_wire = 0
    ghat, new_e = {}, {}
    for name, g in grads.items():
        x = g.float() + error[name]
        codes, scale = quantize(x)
        ghat[name] = dequantize(codes, scale, g.shape)
        new_e[name] = x - ghat[name]
        bits_full += g.numel() * 32
        bits_wire += codes.numel() * 8 + scale.numel() * 32
    return ghat, new_e, {"compression_x": bits_full / max(bits_wire, 1)}
