"""Error-feedback gradient compression, port against JAX.

`repro_torch.optim.compression` against `repro.optim.compression` on the
same seeded numpy inputs: int8 codes and f32 scales bitwise (exact .5
ties, which both round half to even, an all-zero block, a size that is
not a multiple of 128), and `ef_compress_decompress`'s dequantized
gradients, carried errors and `compression_x` bitwise over three steps.
Then the counterparts of the reference's own compression tests
(tests/test_optim.py): the round-trip error bound, exact error-feedback
bookkeeping, and an EF-compressed AdamW fit of a quadratic.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from repro.optim import compression as jcomp
from repro_torch.optim import adamw
from repro_torch.optim import compression as comp


def _ties(rs, n):
    """Values whose codes land on exact .5 ties: each block's max is
    127 * 2^-4, so its scale is exactly 2^-4 and k.5 * 2^-4 divides to
    k.5 exactly (k = -3..3, both parities)."""
    x = rs.standard_normal(n).astype(np.float32) * 0.1
    x[::128] = 127.0 / 16.0
    x[1::7] = (np.arange(-3, 4)[np.arange(len(x[1::7])) % 7] + 0.5) / 16.0
    return x


CASES = {
    "normal": lambda rs: rs.standard_normal((3, 100)).astype(np.float32),
    "ties": lambda rs: _ties(rs, 512),
    "zero_block": lambda rs: np.concatenate(
        [np.zeros(128, np.float32),
         rs.standard_normal(200).astype(np.float32) * 1e-3]),
    "ragged": lambda rs: rs.standard_normal(1000).astype(np.float32) * 3.0,
}


@pytest.mark.parametrize("case", CASES)
def test_quantize_codes_and_scales_bitwise(case):
    g = CASES[case](np.random.default_rng(len(case)))
    jc, js = jcomp.quantize(jnp.asarray(g))
    tc, ts = comp.quantize(torch.from_numpy(g))
    assert tc.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        comp.dequantize(tc, ts, g.shape).numpy(),
        np.asarray(jcomp.dequantize(jc, js, g.shape)))
    if case == "ties":  # the ties are there and round to even
        q = np.abs(g[1::7] * 16.0)
        assert np.all(q % 1 == 0.5)
        np.testing.assert_array_equal(tc.numpy().reshape(-1)[1::7],
                                      np.round(g[1::7] * 16.0))
    if case == "zero_block":
        assert float(ts[0]) == 0.0 and not tc[0].any()


def test_ef_compress_decompress_bitwise_over_three_steps():
    rs = np.random.default_rng(0)
    shapes = {"w": (8, 40), "b": (130,), "ln": (7,)}
    jerr = jcomp.ef_init({n: jnp.zeros(s) for n, s in shapes.items()})
    terr = comp.ef_init({n: torch.zeros(s) for n, s in shapes.items()})
    for step in range(3):
        g = {n: (rs.standard_normal(s) * 10.0 ** -step).astype(np.float32)
             for n, s in shapes.items()}
        jhat, jerr, jstats = jcomp.ef_compress_decompress(
            {n: jnp.asarray(a) for n, a in g.items()}, jerr)
        that, terr, tstats = comp.ef_compress_decompress(
            {n: torch.from_numpy(a) for n, a in g.items()}, terr)
        for n in shapes:
            np.testing.assert_array_equal(that[n].numpy(),
                                          np.asarray(jhat[n]), err_msg=n)
            np.testing.assert_array_equal(terr[n].numpy(),
                                          np.asarray(jerr[n]), err_msg=n)
        assert tstats == jstats
        assert any(float(e.abs().max()) > 0 for e in terr.values())


def test_quantize_roundtrip_error_bounded():
    g = torch.from_numpy(
        np.random.default_rng(0).standard_normal(1000).astype(np.float32)
        * 3.0)
    codes, scale = comp.quantize(g)
    err = (comp.dequantize(codes, scale, g.shape) - g).abs()
    # int8 block quantization: error <= scale/2 per block
    assert float(err.max()) <= float(scale.max()) * 0.51 + 1e-6


def test_error_feedback_accumulates_residual():
    grads = {"w": torch.from_numpy(
        np.random.default_rng(1).standard_normal(256).astype(np.float32)
        * 0.01)}
    ghat, err2, stats = comp.ef_compress_decompress(grads,
                                                    comp.ef_init(grads))
    assert stats["compression_x"] > 3.8
    # decompressed + residual == original (exactness of EF bookkeeping)
    np.testing.assert_allclose((ghat["w"] + err2["w"]).numpy(),
                               grads["w"].numpy(), atol=1e-6)


def test_ef_compression_preserves_convergence():
    """EF-compressed AdamW still fits the quadratic (the convergence
    property plain quantization loses)."""
    cfg = adamw.AdamWConfig(lr=0.05, weight_decay=0.0, total_steps=300,
                            warmup_steps=0, schedule="constant")
    target = torch.tensor([0.5, -1.5, 2.5, 0.1])
    params = {"w": torch.zeros(4)}
    state = adamw.init(params)
    err = comp.ef_init(params)
    for _ in range(300):
        grads = {"w": 2 * (params["w"] - target)}
        grads, err, _ = comp.ef_compress_decompress(grads, err)
        adamw.update(params, grads, state, cfg)
    assert float((params["w"] - target).abs().max()) < 0.05
