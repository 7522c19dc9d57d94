"""The port's quantizer and quantized matmul against the JAX reference on
the Pallas route (interpret mode): ``quantize_symmetric`` and
``quantized_matmul`` at w in {8, 12} on fp32 and bf16 inputs must be
``array_equal`` — the fused kernel's dequant epilogue makes the whole
quantized GEMM a deterministic function of the inputs.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.context import ExecContext as JaxContext  # noqa: E402
from repro.quant.policy import POLICY_MIXED as JAX_MIXED  # noqa: E402
from repro.quant.qmatmul import quantized_matmul as jax_qmm  # noqa: E402
from repro.quant.quantize import quantize_symmetric as jax_quant  # noqa: E402
from repro_torch.bridge import array_to_numpy, array_to_torch  # noqa: E402
from repro_torch.core.context import ExecContext  # noqa: E402
from repro_torch.kernels import fused_gemm as fg  # noqa: E402
from repro_torch.quant.policy import POLICY_MIXED  # noqa: E402
from repro_torch.quant import qmatmul  # noqa: E402
from repro_torch.quant.qmatmul import quantized_matmul  # noqa: E402
from repro_torch.quant.quantize import quantize_symmetric  # noqa: E402


def _inputs(shape_x, shape_w, dtype, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape_x).astype(np.float32)
    wm = (rng.standard_normal(shape_w) * 0.1).astype(np.float32)
    if dtype == "bfloat16":
        x = np.array(jnp.asarray(x, jnp.bfloat16))
    return x, wm


def _np(t):
    return np.asarray(array_to_numpy(t)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [4, 8, 12])
def test_quantize_symmetric_matches_jax(bits, dtype):
    x, _ = _inputs((3, 5, 40), (1, 1), dtype, seed=bits)
    x[0, 0] = 0.0                       # an all-zero row: scale floor 1e-8
    for axis in (None, -1, 0):
        qj, sj = jax_quant(jnp.asarray(x), bits, axis=axis)
        qt, st = quantize_symmetric(array_to_torch(x), bits, axis=axis)
        np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
        assert qt.dtype == torch.int32 and st.dtype == torch.float32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [8, 12])
def test_quantized_matmul_matches_jax(bits, dtype):
    fg.reset_launches()
    jctx = JaxContext(backend="pallas")
    # (B, S, K) x (K, N) with a ragged K (padded K != K) and a transposed
    # weight view, as the tied lm_head passes embed.T.
    for i, (sx_, sw_, transpose) in enumerate(
            [((2, 5, 64), (64, 48), False), ((3, 1, 70), (40, 70), True)]):
        x, wm = _inputs(sx_, sw_, dtype, seed=100 * bits + i)
        ref = jax_qmm(jnp.asarray(x), jnp.asarray(wm).T if transpose
                      else jnp.asarray(wm), bits, context=jctx)
        wt = array_to_torch(wm)
        got = quantized_matmul(array_to_torch(x), wt.T if transpose else wt,
                               bits, context=ExecContext())
        assert str(ref.dtype) == str(got.dtype).replace("torch.", "")
        assert tuple(got.shape) == tuple(ref.shape)
        np.testing.assert_array_equal(_np(got), np.asarray(
            ref.astype(jnp.float32)), err_msg=f"shape {sx_} x {sw_}")
    assert fg.launches == {mode: 0 for mode in fg.MODES}


def test_mixed_policy_sites_match_reference():
    """The mixed policy as the reference has it: w=12 on lm_head only for a
    dense model (its *o_proj / *router patterns match no dense site)."""
    sites = ["lm_head", "blk0.attn.wq", "blk0.attn.wo", "blk0.mlp.wo",
             "blk0.mlp.wg"]
    assert [POLICY_MIXED.bits_for(s) for s in sites] == \
        [JAX_MIXED.bits_for(s) for s in sites] == [12, 8, 8, 8, 8]


def test_outside_fused_window_takes_the_aten_route():
    """No silent route change: w=27 (digit recursion of depth 3) and
    force_mode="mm2" take the ATen route, as the reference's take its XLA
    route — equal to JAX's "pallas" context, and counted."""
    rng = np.random.default_rng(27)
    x = rng.standard_normal((2, 32)).astype(np.float32)
    wm = rng.standard_normal((32, 8)).astype(np.float32)
    qmatmul.reset_gemm_routes()
    for bits, mode in ((27, "auto"), (8, "mm2"), (12, "mm2")):
        ref = jax_qmm(jnp.asarray(x), jnp.asarray(wm), bits,
                      context=JaxContext(backend="pallas", force_mode=mode))
        got = quantized_matmul(array_to_torch(x), array_to_torch(wm), bits,
                               context=ExecContext(force_mode=mode))
        np.testing.assert_array_equal(_np(got), np.asarray(ref))
    assert qmatmul.gemm_routes() == {("cuda", "aten_fallback"): 1,
                                     ("cuda", "aten"): 2}
