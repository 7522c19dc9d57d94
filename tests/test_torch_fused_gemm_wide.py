"""The port's fused GEMM in its wide modes — mm2 at w in {15, 16} and
depth-2 kmm4 at w in {17, 20, 22, 23, 24, 25, 26} — against the JAX Pallas
kernel run in interpret mode, dense and grouped (dense and ragged counts).
The plain PyTorch version, which the wrappers run for CPU tensors, must
equal the reference bit for bit (``array_equal``): ragged M/K/N, the
tile-clamped and a hostile ``block_k``, raw outputs and the dequant
epilogue in fp32 and bf16, the fp32 and the int32-ring combine.

Two reference behaviours are pinned here, not repaired: the zero-point row
and column sums wrap modulo 2^32 (at w = 24 a row of 2^22s wraps once K
reaches 512, and the result is then far from the exact product), and at
w = 26 the quantizer emits +-2^25, one past qmax, which the digit split
must take.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.fused_gemm import fused_gemm as jax_fused_gemm  # noqa: E402
from repro.kernels.fused_gemm import \
    fused_gemm_grouped as jax_grouped  # noqa: E402
from repro_torch.kernels import fused_gemm as fg  # noqa: E402
from repro_torch.kernels.ref import ref_int_gemm_i64  # noqa: E402
from repro_torch.quant.qmatmul import _pow2_cover  # noqa: E402

WIDTHS = [(15, "mm2"), (16, "mm2"), (17, "kmm4"), (20, "kmm4"),
          (22, "kmm4"), (23, "kmm4"), (24, "kmm4"), (25, "kmm4"),
          (26, "kmm4")]
SHAPES = [(33, 70, 17), (5, 300, 40), (1, 64, 1)]
NO_LAUNCH = {mode: 0 for mode in fg.MODES}
J_OUT = {"bf16": jnp.bfloat16, "f32": jnp.float32, None: None}
T_OUT = {"bf16": torch.bfloat16, "f32": torch.float32, None: None}


def _operands(w, lead, m, k, n, seed):
    rng = np.random.default_rng(seed)
    q = 2 ** (w - 1) - 1
    a = rng.integers(-q, q + 1, size=lead + (m, k)).astype(np.int32)
    b = rng.integers(-q, q + 1, size=lead + (k, n)).astype(np.int32)
    sx = (rng.random(lead + (m, 1), dtype=np.float32) + 0.5) * 1e-2
    sw = (rng.random(lead + (1, n), dtype=np.float32) + 0.5) * 1e-2
    return a, b, sx, sw


def _dense_both(a, b, sx, sw, out, **kw):
    deq = sx is not None
    ref = jax_fused_gemm(jnp.asarray(a), jnp.asarray(b),
                         jnp.asarray(sx) if deq else None,
                         jnp.asarray(sw) if deq else None,
                         out_dtype=J_OUT[out], interpret=True, block_m=32,
                         block_n=32, **kw)
    got = fg.fused_gemm(torch.from_numpy(a), torch.from_numpy(b),
                        torch.from_numpy(sx) if deq else None,
                        torch.from_numpy(sw) if deq else None,
                        out_dtype=T_OUT[out], **kw)
    assert str(ref.dtype) == str(got.dtype).replace("torch.", "")
    if got.dtype == torch.bfloat16:
        return (np.asarray(ref.astype(jnp.float32)),
                got.to(torch.float32).numpy())
    return np.asarray(ref), got.numpy()


def _wrap(x):
    return ((x + 2 ** 31) % 2 ** 32 - 2 ** 31).astype(np.int64)


@pytest.mark.parametrize("w,mode", WIDTHS)
def test_wide_modes_match_jax(w, mode):
    fg.reset_launches()
    shape = SHAPES[w % len(SHAPES)]
    a, b, sx, sw = _operands(w, (), *shape, seed=w)
    clamped = min(256, _pow2_cover(shape[1]))
    hostile = 8 if w % 2 else 32
    runs = [(clamped, False, None), (clamped, False, "bf16"),
            (clamped, True, "f32"), (clamped, True, "bf16"),
            (hostile, True, "bf16")]
    for block_k, scales, out in runs:
        ref, got = _dense_both(a, b, sx if scales else None,
                               sw if scales else None, out, w=w, mode=mode,
                               block_k=block_k)
        np.testing.assert_array_equal(
            got, ref, err_msg=f"w={w} {shape} block_k={block_k} "
                              f"scales={scales} out={out}")
    # The int32-ring combine: the product modulo 2^32, like the reference
    # (whose z^2 kp must fit int32, so the deepest widths take K <= 64).
    if w >= 25:
        a, b = a[:, :64], b[:64]
    ref, got = _dense_both(a, b, None, None, None, w=w, mode=mode,
                           block_k=8 if w >= 25 else clamped,
                           combine_int32=True)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got.astype(np.int64),
                                  _wrap(ref_int_gemm_i64(a, b)))
    # CPU tensors run the plain version: the CUDA kernel never launched.
    assert fg.launches == NO_LAUNCH and fg.grouped_launches == NO_LAUNCH


@pytest.mark.parametrize("w,mode", [(16, "mm2"), (20, "kmm4"),
                                    (24, "kmm4")])
def test_wide_int32_combine_is_exact_without_wrap(w, mode):
    """Operands small enough that the product fits int32: the int32-ring
    combine is the exact product (the int64 oracle)."""
    rng = np.random.default_rng(w)
    a = rng.integers(-2 ** 9, 2 ** 9, size=(9, 100)).astype(np.int32)
    b = rng.integers(-2 ** 9, 2 ** 9, size=(100, 11)).astype(np.int32)
    a[0, :4] = 2 ** (w - 1) - 1                  # a few full-width digits
    b[:4] = rng.integers(-3, 4, size=(4, 11))
    ref, got = _dense_both(a, b, None, None, None, w=w, mode=mode,
                           block_k=32, combine_int32=True)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got.astype(np.int64),
                                  ref_int_gemm_i64(a, b))


E, C, K, N = 3, 20, 70, 17
SEG = 6
COUNTS = np.array([[2, 0, 5], [0, 0, 0], [6, 6, 1]], np.int32)


@pytest.mark.parametrize("w,mode", WIDTHS)
def test_wide_grouped_matches_jax(w, mode):
    fg.reset_launches()
    a, b, sx, sw = _operands(w, (E,), C, K, N, seed=100 + w)
    block_k = 32 if w % 2 else min(256, _pow2_cover(K))
    live = fg.ragged_row_mask(torch.from_numpy(COUNTS), SEG, C).numpy()
    for counts, scales, out in ((None, False, None), (COUNTS, False, None),
                                (COUNTS, True, "f32"),
                                (COUNTS, True, "bf16")):
        ragged = counts is not None
        deq = scales
        ref = jax_grouped(jnp.asarray(a), jnp.asarray(b),
                          jnp.asarray(sx) if deq else None,
                          jnp.asarray(sw) if deq else None,
                          jnp.asarray(counts) if ragged else None,
                          seg=SEG if ragged else None, w=w, mode=mode,
                          block_k=block_k, out_dtype=J_OUT[out],
                          interpret=True, block_m=8, block_n=16)
        got = fg.fused_gemm_grouped(
            torch.from_numpy(a), torch.from_numpy(b),
            torch.from_numpy(sx) if deq else None,
            torch.from_numpy(sw) if deq else None,
            torch.from_numpy(counts) if ragged else None,
            seg=SEG if ragged else None, w=w, mode=mode, block_k=block_k,
            out_dtype=T_OUT[out])
        assert str(ref.dtype) == str(got.dtype).replace("torch.", "")
        ref = np.asarray(ref.astype(jnp.float32))
        got = got.to(torch.float32).numpy()
        np.testing.assert_array_equal(
            got, ref, err_msg=f"w={w} ragged={ragged} out={out}")
        if ragged:
            assert not got[~np.broadcast_to(live, got.shape)].any()
    assert fg.launches == NO_LAUNCH and fg.grouped_launches == NO_LAUNCH


def test_int32_row_sum_wrap_is_pinned():
    """At w = 24 and K = 4096 a row of 2^22s sums to 2^34 in the
    reference's int32 scratch, which wraps: the port wraps the same way,
    so both miss the exact product by the same ~9 %, while a random-sign
    row stays within fp32 rounding of it.  Dense and grouped."""
    w, k = 24, 4096
    rng = np.random.default_rng(24)
    a = np.empty((3, k), np.int32)
    a[0] = 2 ** 22
    a[1] = rng.integers(-2 ** 23 + 1, 2 ** 23, k)
    a[2] = -2 ** 22
    b = rng.integers(-2 ** 23 + 1, 2 ** 23, (k, 5)).astype(np.int32)
    ref, got = _dense_both(a, b, None, None, None, w=w, mode="kmm4",
                           block_k=256)
    np.testing.assert_array_equal(got, ref)
    exact = ref_int_gemm_i64(a, b).astype(np.float64)
    rel = np.abs(got / exact - 1).max(axis=1)
    assert rel[0] > 0.01 and rel[2] > 0.01, rel      # the wrap shows
    assert rel[1] < 1e-5, rel
    grouped = fg.fused_gemm_grouped(
        torch.from_numpy(np.stack([a, a[::-1]])),
        torch.from_numpy(np.stack([b, b])), w=w, mode="kmm4", block_k=256)
    np.testing.assert_array_equal(grouped[0].numpy(), got)
    np.testing.assert_array_equal(grouped[1].numpy(), got[::-1])


def test_edge_values_at_w26():
    """+-2^25, one past qmax (what the reference's quantizer emits at
    w = 26), in both operands: the port equals JAX in every epilogue."""
    w = 26
    a, b, sx, sw = _operands(w, (), 6, 40, 9, seed=26)
    a[0, :] = 2 ** 25
    a[1, :] = -2 ** 25
    a[2, ::2] = 2 ** 25
    b[:, 0] = 2 ** 25
    b[:, 1] = -2 ** 25
    b[::3, 2] = 2 ** 25
    for scales, out in ((False, None), (True, "f32"), (True, "bf16")):
        ref, got = _dense_both(a, b, sx if scales else None,
                               sw if scales else None, out, w=w,
                               mode="kmm4", block_k=64)
        np.testing.assert_array_equal(got, ref, err_msg=f"out={out}")
    # fp32 combine: a few roundings of terms up to ~2^55, so within 1e-6
    # of the largest exact value
    exact = ref_int_gemm_i64(a, b).astype(np.float64)
    ref, got = _dense_both(a, b, None, None, None, w=w, mode="kmm4",
                           block_k=64)
    assert np.abs(got - exact).max() <= 1e-6 * np.abs(exact).max()


def test_wide_modes_outside_their_windows_raise():
    a = torch.zeros((4, 8), dtype=torch.int32)
    b = torch.zeros((8, 3), dtype=torch.int32)
    for w, mode in ((8, "mm2"), (17, "mm2"), (8, "kmm4"), (27, "kmm4"),
                    (15, "auto")):
        with pytest.raises(ValueError):
            fg.fused_gemm(a, b, w=w, mode=mode)
    assert fg.resolve(16, mode="mm2")[3] == torch.int16
    assert fg.resolve(17, mode="kmm4")[3] == torch.int32
    assert fg.resolve(12, mode="kmm4")[3] == torch.int32   # tuner-only
