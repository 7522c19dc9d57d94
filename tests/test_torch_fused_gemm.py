"""The port's fused GEMM (repro_torch.kernels.fused_gemm) against the JAX
Pallas kernel run in interpret mode: the plain PyTorch version, which the
wrapper runs for CPU tensors, must equal the reference bit for bit
(``array_equal``) for mm1 at w in {4, 8} and kmm2 at w in {9, 12, 14} —
ragged M/K/N, the tile-clamped and a hostile ``block_k`` (the padded K is
part of the fp32 numerics), raw and dequant outputs in fp32 and bf16.
Exact-int plans also equal the int64 oracle.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.fused_gemm import fused_gemm as jax_fused_gemm  # noqa: E402
from repro_torch.kernels import fused_gemm as fg  # noqa: E402
from repro_torch.kernels.ref import ref_int_gemm_i64  # noqa: E402
from repro_torch.quant.qmatmul import _pow2_cover  # noqa: E402

# Non-multiple M/N/K and 1-row/1-col extremes; K padding exercises the
# z-correction on padded positions.
SHAPES = [(33, 70, 17), (1, 64, 1), (5, 300, 40)]


def _operands(w, shape, seed):
    rng = np.random.default_rng(seed)
    m, k, n = shape
    q = 2 ** (w - 1) - 1
    a = rng.integers(-q, q + 1, size=(m, k)).astype(np.int32)
    b = rng.integers(-q, q + 1, size=(k, n)).astype(np.int32)
    sx = (rng.random((m, 1), dtype=np.float32) + 0.5) * 1e-2
    sw = (rng.random((1, n), dtype=np.float32) + 0.5) * 1e-2
    return a, b, sx, sw


def _run_both(a, b, sx, sw, out, **kw):
    """The reference with small M/N tiles (they never change a value) and
    the port, on the same operands."""
    jod = {"bf16": jnp.bfloat16, "f32": jnp.float32, None: None}[out]
    tod = {"bf16": torch.bfloat16, "f32": torch.float32, None: None}[out]
    deq = sx is not None
    ref = jax_fused_gemm(jnp.asarray(a), jnp.asarray(b),
                         jnp.asarray(sx) if deq else None,
                         jnp.asarray(sw) if deq else None,
                         out_dtype=jod, interpret=True, block_m=32,
                         block_n=32, **kw)
    got = fg.fused_gemm(torch.from_numpy(a), torch.from_numpy(b),
                        torch.from_numpy(sx) if deq else None,
                        torch.from_numpy(sw) if deq else None,
                        out_dtype=tod, **kw)
    if out == "bf16":
        return (np.asarray(ref.astype(jnp.float32)),
                got.to(torch.float32).numpy(), ref.dtype, got.dtype)
    return np.asarray(ref), got.numpy(), ref.dtype, got.dtype


@pytest.mark.parametrize("w", [4, 8, 9, 12, 14])
def test_fused_gemm_matches_jax(w):
    fg.reset_launches()
    shapes = [SHAPES[0], SHAPES[1] if w in (4, 9) else SHAPES[2]]
    for i, shape in enumerate(shapes):
        a, b, sx, sw = _operands(w, shape, seed=10 * w + i)
        clamped = min(256, _pow2_cover(shape[1]))
        runs = [(clamped, False, None), (clamped, True, "f32"),
                (clamped, True, "bf16"), (32, True, "bf16")]
        for block_k, scales, out in runs:
            ref, got, rdt, gdt = _run_both(
                a, b, sx if scales else None, sw if scales else None, out,
                w=w, block_k=block_k)
            assert str(rdt) == str(gdt).replace("torch.", ""), (rdt, gdt)
            np.testing.assert_array_equal(
                got, ref, err_msg=f"w={w} {shape} block_k={block_k} "
                                  f"scales={scales} out={out}")
            if w <= 8 and not scales:
                np.testing.assert_array_equal(got.astype(np.int64),
                                              ref_int_gemm_i64(a, b))
    # CPU tensors run the plain version: the CUDA kernel never launched.
    assert fg.launches == {mode: 0 for mode in fg.MODES}


@pytest.mark.parametrize("w", [9, 12, 14])
def test_kmm2_raw_bf16_and_int32_combine(w):
    """kmm2 raw fp32 combine rounded to bf16 matches JAX; the int32 combine
    is the exact product (int64 oracle) and matches JAX too."""
    a, b, sx, sw = _operands(w, (7, 130, 33), seed=w)
    ref, got, _, _ = _run_both(a, b, None, None, "bf16", w=w, block_k=64)
    np.testing.assert_array_equal(got, ref)
    ref, got, rdt, gdt = _run_both(a, b, None, None, None, w=w, block_k=64,
                                   combine_int32=True)
    assert str(rdt) == "int32" and gdt == torch.int32
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got.astype(np.int64),
                                  ref_int_gemm_i64(a, b))
    ref, got, _, _ = _run_both(a, b, sx, sw, "bf16", w=w, block_k=64,
                               combine_int32=True)
    np.testing.assert_array_equal(got, ref)


def test_padded_k_changes_fp32_value_like_jax():
    """At w=14 and deep K the fp32 combine rounds, so two padded Ks give
    different values — and the port follows the reference in both."""
    w = 14
    a, b, _, _ = _operands(w, (3, 1000, 5), seed=3)
    outs = []
    for block_k in (8, 256):
        ref, got, _, _ = _run_both(a, b, None, None, None, w=w,
                                   block_k=block_k)
        np.testing.assert_array_equal(got, ref)
        outs.append(got)
    exact = ref_int_gemm_i64(a, b).astype(np.float64)
    assert np.abs(outs[1] - exact).max() > 0     # fp32 rounding is real


def test_wrapper_validates_inputs():
    a = torch.zeros((4, 8), dtype=torch.int8)
    b = torch.zeros((8, 3), dtype=torch.int8)
    with pytest.raises(ValueError):
        fg.fused_gemm(a, b[:4], w=8)                   # K mismatch
    with pytest.raises(TypeError):
        fg.fused_gemm(a.float(), b, w=8)               # float operands
    with pytest.raises(ValueError):
        fg.fused_gemm(a, b, torch.ones(4, 1), None, w=8)   # one scale
    with pytest.raises(ValueError):
        fg.fused_gemm(a, b, w=12, out_dtype=torch.int32)   # fp32 combine
    with pytest.raises(ValueError):
        fg.fused_gemm(a, b, w=15)                      # digits exceed s8
    with pytest.raises(ValueError):
        fg.fused_gemm(a, b, w=27, mode="kmm4")         # depth 3: no s8 digits
