"""The port's grouped fused GEMM (repro_torch.kernels.fused_gemm_grouped)
against the JAX Pallas kernel run in interpret mode: the plain PyTorch
version, which the wrapper runs for CPU tensors, must equal the reference
bit for bit (``array_equal``) for mm1 at w in {4, 8} and kmm2 at w in
{9, 12, 14} — dense and ragged counts (a zero-count expert, full and
partial segments, a ``seg`` that does not divide the reference's
``block_m``, rows past the last segment), raw and dequantized outputs in
fp32 and bf16.  Dead rows are exact zeros, and each group's live rows equal
a dense ``fused_gemm`` call on that group.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.fused_gemm import \
    fused_gemm_grouped as jax_grouped  # noqa: E402
from repro.quant.qmatmul import _ragged_row_mask as jax_mask  # noqa: E402
from repro_torch.kernels import fused_gemm as fg  # noqa: E402
from repro_torch.quant.qmatmul import _pow2_cover  # noqa: E402

E, C, K, N = 3, 20, 70, 17
SEG = 6                 # 20 rows = 3 segments of 6 + 2 rows past the last
# expert 0 partial segments, expert 1 zero tokens, expert 2 full segments
COUNTS = np.array([[2, 0, 5], [0, 0, 0], [6, 6, 1]], np.int32)
BLOCK_M = 8             # the reference's m tile; SEG does not divide it


def _operands(w, seed):
    rng = np.random.default_rng(seed)
    q = 2 ** (w - 1) - 1
    a = rng.integers(-q, q + 1, size=(E, C, K)).astype(np.int32)
    b = rng.integers(-q, q + 1, size=(E, K, N)).astype(np.int32)
    sx = (rng.random((E, C, 1), dtype=np.float32) + 0.5) * 1e-2
    sw = (rng.random((E, 1, N), dtype=np.float32) + 0.5) * 1e-2
    return a, b, sx, sw


def _run_both(a, b, sx, sw, counts, out, **kw):
    jod = {"bf16": jnp.bfloat16, "f32": jnp.float32, None: None}[out]
    tod = {"bf16": torch.bfloat16, "f32": torch.float32, None: None}[out]
    deq = sx is not None
    ragged = counts is not None
    ref = jax_grouped(jnp.asarray(a), jnp.asarray(b),
                      jnp.asarray(sx) if deq else None,
                      jnp.asarray(sw) if deq else None,
                      jnp.asarray(counts) if ragged else None,
                      seg=SEG if ragged else None, out_dtype=jod,
                      interpret=True, block_m=BLOCK_M, block_n=16, **kw)
    got = fg.fused_gemm_grouped(
        torch.from_numpy(a), torch.from_numpy(b),
        torch.from_numpy(sx) if deq else None,
        torch.from_numpy(sw) if deq else None,
        torch.from_numpy(counts) if ragged else None,
        seg=SEG if ragged else None, out_dtype=tod, **kw)
    assert str(ref.dtype) == str(got.dtype).replace("torch.", "")
    return (np.asarray(ref.astype(jnp.float32)),
            got.to(torch.float32).numpy() if out == "bf16" else got.numpy())


@pytest.mark.parametrize("w", [4, 8, 9, 12, 14])
def test_grouped_matches_jax(w):
    fg.reset_launches()
    a, b, sx, sw = _operands(w, seed=w)
    block_k = min(256, _pow2_cover(K))
    runs = [(None, False, None), (COUNTS, False, None),
            (COUNTS, True, "f32"), (COUNTS, True, "bf16")]
    live = fg.ragged_row_mask(torch.from_numpy(COUNTS), SEG, C).numpy()
    for counts, scales, out in runs:
        ref, got = _run_both(a, b, sx if scales else None,
                             sw if scales else None, counts, out, w=w,
                             block_k=block_k)
        np.testing.assert_array_equal(
            got, ref, err_msg=f"w={w} ragged={counts is not None} "
                              f"scales={scales} out={out}")
        if counts is not None:
            assert not got[~np.broadcast_to(live, got.shape)].any()
    # CPU tensors run the plain version: the CUDA kernel never launched.
    assert fg.grouped_launches == {mode: 0 for mode in fg.MODES}
    assert fg.launches == {mode: 0 for mode in fg.MODES}


@pytest.mark.parametrize("w,out_dtype", [(8, None), (12, torch.bfloat16)])
def test_groups_equal_dense_calls(w, out_dtype):
    """Each group's live rows equal a dense fused_gemm on its slices; dead
    rows are exact zeros (also in bf16 and with the dequant epilogue)."""
    a, b, sx, sw = (torch.from_numpy(t) for t in _operands(w, seed=50 + w))
    counts = torch.from_numpy(COUNTS)
    live = fg.ragged_row_mask(counts, SEG, C)[..., 0]
    for scales in (False, True):
        s_x, s_w = (sx, sw) if scales else (None, None)
        got = fg.fused_gemm_grouped(a, b, s_x, s_w, counts, w=w, seg=SEG,
                                    block_k=128, out_dtype=out_dtype)
        for e in range(E):
            dense = fg.fused_gemm(a[e], b[e], None if s_x is None else s_x[e],
                                  None if s_w is None else s_w[e], w=w,
                                  block_k=128, out_dtype=out_dtype)
            assert torch.equal(got[e][live[e]], dense[live[e]])
            assert torch.equal(got[e][~live[e]],
                               torch.zeros_like(dense[~live[e]]))
        assert int(live.sum()) == 2 + 5 + 6 + 6 + 1


def test_ragged_row_mask_matches_jax():
    for seg, c_dim in ((SEG, C), (4, 12), (1, 3), (8, 40)):
        n_seg = max(1, min(3, c_dim // seg))
        counts = np.random.default_rng(seg).integers(
            0, seg + 2, size=(E, n_seg)).astype(np.int32)
        ref = np.asarray(jax_mask(jnp.asarray(counts), seg, c_dim))
        got = fg.ragged_row_mask(torch.from_numpy(counts), seg, c_dim)
        np.testing.assert_array_equal(got.numpy(), ref)


def test_grouped_wrapper_validates_inputs():
    a = torch.zeros((2, 8, 16), dtype=torch.int8)
    b = torch.zeros((2, 16, 4), dtype=torch.int8)
    counts = torch.ones((2, 1), dtype=torch.int32)
    with pytest.raises(ValueError):
        fg.fused_gemm_grouped(a, b[:1], w=8)           # expert mismatch
    with pytest.raises(ValueError):
        fg.fused_gemm_grouped(a[0], b[0], w=8)         # not grouped
    with pytest.raises(ValueError):
        fg.fused_gemm_grouped(a, b, counts=counts, w=8)    # no seg
    with pytest.raises(ValueError):
        fg.fused_gemm_grouped(a, b, counts=counts[:1], seg=8, w=8)
    with pytest.raises(TypeError):
        fg.fused_gemm_grouped(a, b, counts=counts.float(), seg=8, w=8)
    with pytest.raises(ValueError):
        fg.fused_gemm_grouped(a, b, torch.ones(2, 8, 1), None, w=8)
