"""The row-invariant matmul and norm (repro_torch.kernels.rowinv).

On the CPU the wrappers run their plain versions, which must be exactly
the ATen expressions the models ran before (so the models' parity with
JAX is untouched); they are also held to the reference's ``norm_apply``
(JAX) within 1e-6.  The CUDA kernels (``csrc/rowinv.cu``) run only on the
card, where ``chip_smoke.py`` holds them to these plain versions and their
rows at every M from 1 to 256 to the same rows of M = 256.

Here a numpy emulation of each kernel's fixed reduction order stands in
for the kernel: the matmul's interleaved lanes (``matmul_lanes(K)``: a
warp, or four from K = 1024), each a chain of fused multiply-adds
(emulated in float64: the product of two float32 is exact there, so only
the rare double rounding of the add can differ from a true fma), then the
xor butterfly (16, 8, 4, 2, 1) within each warp and the warp sums in
order; the norm's threads
(``norm_threads(d)``), each summing its elements in order, the butterfly
within a warp and the warp sums in order.  The emulation gives identical
rows whatever the number of rows, and stays within rtol 1e-5 of the plain
version at rwkv's widths, with inputs at the model's scales (activations
of order 1, weights at the init's K^-1/2): the two sum in different
orders, so they agree to float32 rounding.  The norm's atol is 1e-6.  A
matmul output is a sum of K products whose rounding error scales with
the products, not with the sum, so near-zero outputs of the K = 2560
product differ by up to ~2e-6 (the plain version's own error against
float64: 1.8e-6); its atol is 1e-5 of the output's largest value, as the
WKV tests hold their kernel, and the emulation is also held within 1e-6
of the float64 product.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.models.layers import norm_apply as jax_norm_apply  # noqa: E402
from repro_torch.kernels import launch_counts, rowinv  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
ROWS = [1, 2, 3, 4, 8, 17, 32, 64, 128, 256]
# rwkv6-3b's decay LoRA products and d_model; the other configs' widths.
LORA_SHAPES = [(2560, 64), (64, 2560), (1000, 40)]
NORM_WIDTHS = [2560, 2048, 1536, 5120, 6144, 64, 100]


def _old_norm(p, x, kind="rms", eps=1e-6):
    """``layers.norm_apply`` as it was before the kernel: the ATen ops."""
    xf = x.to(torch.float32)
    if kind == "ln":
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        out = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    else:
        ms = (xf * xf).mean(-1, keepdim=True)
        out = xf * torch.rsqrt(ms + eps) * p["scale"]
    return out.to(x.dtype)


def _norm_params(rng, d, kind):
    p = {"scale": torch.from_numpy(
        (1 + 0.1 * rng.standard_normal(d)).astype(np.float32))}
    if kind == "ln":
        p["bias"] = torch.from_numpy(
            (0.1 * rng.standard_normal(d)).astype(np.float32))
    return p


@pytest.mark.parametrize("kind", ["rms", "ln"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_norm_is_the_old_aten_expression(kind, dtype):
    rng = np.random.default_rng(1)
    p = _norm_params(rng, 256, kind)
    x = torch.from_numpy(rng.standard_normal((3, 5, 256)).astype(np.float32)
                         + 0.3).to(dtype)
    rowinv.reset_launches()
    want = _old_norm(p, x, kind)
    for got in (L.norm_apply(p, x, kind=kind),
                rowinv.rowinv_norm(x, p["scale"], p.get("bias"), kind=kind)):
        assert got.dtype == dtype and torch.equal(got, want)
    # a strided view of rows (prefill's last position) runs the same
    last = x[:, -1][:, None, :]
    assert torch.equal(L.norm_apply(p, last, kind=kind), want[:, -1:])
    assert rowinv.launches == {"rowinv_matmul": 0, "rowinv_norm": 0}


@pytest.mark.parametrize("kind", ["rms", "ln"])
def test_plain_norm_matches_jax(kind):
    rng = np.random.default_rng(2)
    p = _norm_params(rng, 2560, kind)
    x = rng.standard_normal((4, 2560)).astype(np.float32)
    got = L.norm_apply(p, torch.from_numpy(x), kind=kind).numpy()
    ref = np.asarray(jax_norm_apply({k: jnp.asarray(v.numpy())
                                     for k, v in p.items()},
                                    jnp.asarray(x), kind=kind))
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def test_plain_matmul_is_the_old_aten_expression():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 7, 96)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((96, 64)).astype(np.float32))
    rowinv.reset_launches()
    got = rowinv.rowinv_matmul(x, w)
    assert got.shape == (2, 7, 64) and torch.equal(got, x @ w)
    assert launch_counts()["rowinv_matmul"] == 0


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.zeros((2, 8))
    with pytest.raises(ValueError, match="unknown kind"):
        rowinv.rowinv_norm(x, torch.ones(8), kind="group")
    with pytest.raises(ValueError, match="needs a bias"):
        rowinv.rowinv_norm(x, torch.ones(8), kind="ln")
    meta = torch.zeros((2, 8), device="meta")
    with pytest.raises(ValueError, match="one cpu or cuda device"):
        rowinv.rowinv_matmul(meta, torch.zeros((8, 4), device="meta"))
    with pytest.raises(ValueError, match="one cpu or cuda device"):
        rowinv.rowinv_norm(meta, torch.ones(8, device="meta"))


# ---------------------------------------------------------------------------
# numpy emulations of csrc/rowinv.cu's reduction orders.
# ---------------------------------------------------------------------------


def _fma(a, b, c):
    """float32 fma, emulated in float64 (exact product; the add rounds
    twice, which differs from one rounding only in rare ties)."""
    return (a.astype(np.float64) * b.astype(np.float64)
            + c.astype(np.float64)).astype(np.float32)


def _butterfly(v):
    """The xor butterfly over axis 0 (32 lanes): every lane ends with the
    same sum; lane 0's."""
    idx = np.arange(v.shape[0])
    for off in (16, 8, 4, 2, 1):
        v = (v + v[idx ^ off]).astype(np.float32)
    return v[0]


def _warp_sums_in_order(acc):
    """Each warp's butterfly over axis 0 (its 32 lanes of 32 w), then the
    warp sums in order."""
    sums = [_butterfly(acc[v * 32:(v + 1) * 32])
            for v in range(acc.shape[0] // 32)]
    total = sums[0]
    for s in sums[1:]:
        total = (total + s).astype(np.float32)
    return total


def emulate_matmul(x, w):
    """rowinv_matmul_kernel's order for every output of x (M, K) @ w
    (K, N): lane l of L chains fma over k = l, l + L, ... from 0, then
    each warp's butterfly and the warp sums in order."""
    m, k = x.shape
    lanes = rowinv.matmul_lanes(k)
    steps = -(-k // lanes)
    xp = np.zeros((m, steps * lanes), np.float32)
    xp[:, :k] = x
    wp = np.zeros((steps * lanes, w.shape[1]), np.float32)
    wp[:k] = w
    acc = np.zeros((lanes, m, w.shape[1]), np.float32)
    for s in range(steps):
        cols = slice(s * lanes, (s + 1) * lanes)
        acc = _fma(xp[:, cols].T[:, :, None], wp[cols][:, None, :], acc)
    return _warp_sums_in_order(acc)


def _block_sum(v, nt):
    """rowinv_norm_kernel's sum of each row of v (M, d): thread t adds
    v[t], v[t + nt], ... in order, each warp's butterfly, the warp sums
    in order."""
    m, d = v.shape
    steps = -(-d // nt)
    vp = np.zeros((m, steps * nt), np.float32)
    vp[:, :d] = v
    part = np.zeros((m, nt), np.float32)
    for s in range(steps):
        part = (part + vp[:, s * nt:(s + 1) * nt]).astype(np.float32)
    return _warp_sums_in_order(part.T)


def _rsqrt(v):
    return (1.0 / np.sqrt(v.astype(np.float64))).astype(np.float32)


def emulate_norm(x, scale, bias, kind, eps=1e-6):
    """rowinv_norm_kernel's order for each row of x (M, d), fp32."""
    d = x.shape[1]
    nt = rowinv.norm_threads(d)
    fd, e = np.float32(d), np.float32(eps)
    if kind == "ln":
        mean = (_block_sum(x, nt) / fd).astype(np.float32)[:, None]
        dv = (x - mean).astype(np.float32)
        var = (_block_sum((dv * dv).astype(np.float32), nt)
               / fd).astype(np.float32)[:, None]
        rs = _rsqrt((var + e).astype(np.float32))
        out = ((dv * rs).astype(np.float32) * scale).astype(np.float32)
        return (out + bias).astype(np.float32)
    ms = (_block_sum((x * x).astype(np.float32), nt)
          / fd).astype(np.float32)[:, None]
    rs = _rsqrt((ms + e).astype(np.float32))
    return ((x * rs).astype(np.float32) * scale).astype(np.float32)


@pytest.mark.parametrize("k,n", LORA_SHAPES)
def test_matmul_order_is_row_invariant_and_close_to_plain(k, n):
    rng = np.random.default_rng(k + n)
    x = rng.standard_normal((max(ROWS), k)).astype(np.float32)
    if k == 64:                                   # tanh of the first product
        x = np.tanh(x)
    w = (rng.standard_normal((k, n)) * k ** -0.5).astype(np.float32)
    full = emulate_matmul(x, w)
    for m in ROWS:
        assert np.array_equal(emulate_matmul(x[:m], w), full[:m]), m
    plain = rowinv.rowinv_matmul_reference(torch.from_numpy(x),
                                           torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(full, plain, rtol=RTOL,
                               atol=RTOL * np.abs(plain).max())
    exact = x.astype(np.float64) @ w.astype(np.float64)
    assert np.abs(full - exact).max() <= ATOL


@pytest.mark.parametrize("kind", ["rms", "ln"])
@pytest.mark.parametrize("d", NORM_WIDTHS)
def test_norm_order_is_row_invariant_and_close_to_plain(kind, d):
    rng = np.random.default_rng(d)
    x = (rng.standard_normal((max(ROWS), d)) + 0.5).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(d)).astype(np.float32)
    full = emulate_norm(x, scale, bias, kind)
    for m in ROWS:
        assert np.array_equal(emulate_norm(x[:m], scale, bias, kind),
                              full[:m]), m
    plain = rowinv.rowinv_norm_reference(
        torch.from_numpy(x), torch.from_numpy(scale),
        torch.from_numpy(bias), kind, 1e-6).numpy()
    np.testing.assert_allclose(full, plain, rtol=RTOL, atol=ATOL)


def test_lanes_fixed_by_the_reduced_length():
    assert [rowinv.matmul_lanes(k) for k in (64, 1000, 1024, 2560)] == [
        32, 32, 128, 128]


def test_norm_threads_fixed_by_width():
    assert [rowinv.norm_threads(d) for d in (64, 256, 1536, 2048, 2560,
                                             6144)] == [32, 32, 192, 256,
                                                        256, 256]
