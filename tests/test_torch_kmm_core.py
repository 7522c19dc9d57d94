"""The integer KMM core of the port (``core/kmm.py``, ``core/accum.py``,
``kernels/ffip.py``) against the JAX reference's ``repro.core`` on the
same numpy inputs: Algorithms 1-5, the KSMM baseline and the FFIP literal
``array_equal`` to JAX (dtype included), signed and unsigned, at
n in {1, 2, 4, 8}, int32 and fp32 combines; the brute-force boundary of
``max_exact_k`` at K and K + 1, where the int32 carrier wraps exactly as
the reference's does; and the card's float64 leaf bound, checked on meta
tensors (shapes only).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import accum as jax_accum  # noqa: E402
from repro.core import kmm as jax_kmm  # noqa: E402
from repro.kernels import ffip as jax_ffip  # noqa: E402
from repro_torch.core import accum, kmm  # noqa: E402
from repro_torch.kernels import ffip  # noqa: E402

# (w, n): the reference's test grid, and n = 8 (three KMM levels)
WN = [(8, 1), (8, 2), (12, 2), (14, 2), (12, 4), (16, 2), (16, 4), (8, 8),
      (16, 8), (28, 8)]


def _rand(rng, lo, hi, shape):
    return rng.integers(lo, hi, size=shape).astype(np.int32)


def _operands(w, signed, seed, m=17, k=96, n=23):
    rng = np.random.default_rng(seed)
    lo, hi = (-(2 ** (w - 1)), 2 ** (w - 1)) if signed else (0, 2 ** w)
    return _rand(rng, lo, hi, (m, k)), _rand(rng, lo, hi, (k, n))


def _same(got: torch.Tensor, ref, msg=""):
    ref = np.asarray(ref)
    assert str(got.dtype).replace("torch.", "") == str(ref.dtype), msg
    np.testing.assert_array_equal(got.numpy(), ref, err_msg=msg)


@pytest.mark.parametrize("w,n", WN)
@pytest.mark.parametrize("signed", [False, True])
def test_kmm_mm_match_jax(w, n, signed):
    """Integer combine inside the int32 bound (exact), and past it (the
    ring wraps as the reference's); fp32 combine in the reference's
    order."""
    k = min(max(kmm.max_exact_k(w), 1), 96)
    a, b = _operands(w, signed, w * 100 + n + signed, k=k)
    ref64 = a.astype(np.int64) @ b.astype(np.int64)
    for name in ("kmm_n", "mm_n"):
        for combine in (None, "float32"):
            ref = getattr(jax_kmm, name)(
                jnp.array(a), jnp.array(b), w=w, n=n,
                combine_dtype=combine and jnp.float32)
            got = getattr(kmm, name)(
                torch.from_numpy(a), torch.from_numpy(b), w=w, n=n,
                combine_dtype=combine and torch.float32)
            _same(got, ref, f"{name} w={w} n={n} combine={combine}")
            if combine is None and kmm.max_exact_k(w) >= k:
                np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                              ref64)
    # a wide K on the fp32 combine (accumulators past 2^24)
    a, b = _operands(w, signed, 7 + w, m=6, k=512, n=5)
    for name in ("kmm_n", "mm_n"):
        _same(getattr(kmm, name)(torch.from_numpy(a), torch.from_numpy(b),
                                 w=w, n=n, combine_dtype=torch.float32),
              getattr(jax_kmm, name)(jnp.array(a), jnp.array(b), w=w, n=n,
                                     combine_dtype=jnp.float32),
              f"{name} K=512 w={w} n={n}")


@pytest.mark.parametrize("w,n", [(8, 1), (8, 2), (12, 2), (16, 4), (15, 8),
                                 (31, 2)])
def test_scalar_algorithms_match_jax(w, n):
    rng = np.random.default_rng(n)
    w_eff = min(w, 15)                 # elementwise products fit int32
    for signed in (False, True):
        lo, hi = ((-(2 ** (w_eff - 1)), 2 ** (w_eff - 1)) if signed
                  else (0, 2 ** w_eff))
        a = _rand(rng, lo, hi, (64,))
        b = _rand(rng, lo, hi, (64,))
        for name in ("sm_n", "ksm_n"):
            got = getattr(kmm, name)(torch.from_numpy(a), torch.from_numpy(b),
                                     w=w_eff, n=n)
            _same(got, getattr(jax_kmm, name)(jnp.array(a), jnp.array(b),
                                              w=w_eff, n=n), name)
            np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                          a.astype(np.int64) * b)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_ksmm_matches_jax(n):
    rng = np.random.default_rng(n)
    a = _rand(rng, -2 ** 11, 2 ** 11, (6, 16))
    b = _rand(rng, -2 ** 11, 2 ** 11, (16, 5))
    got = kmm.ksmm(torch.from_numpy(a), torch.from_numpy(b), w=12, n=n)
    _same(got, jax_kmm.ksmm(jnp.array(a), jnp.array(b), w=12, n=n))
    np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                  a.astype(np.int64) @ b.astype(np.int64))


def test_digit_split_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.integers(-2 ** 15, 2 ** 15, size=(128,)).astype(np.int32)
    for h in (1, 4, 7, 8, 14):
        hi, lo = kmm.digit_split(torch.from_numpy(x), h)
        jhi, jlo = jax_kmm.digit_split(jnp.array(x), h)
        _same(hi, jhi)
        _same(lo, jlo)
        assert (lo.numpy() >= 0).all() and (lo.numpy() < 2 ** h).all()
        np.testing.assert_array_equal(
            (hi.numpy().astype(np.int64) << h) + lo.numpy(), x)
    with pytest.raises(ValueError):
        kmm.digit_split(torch.from_numpy(x), 0)
    with pytest.raises(ValueError):
        kmm.kmm_n(torch.ones(2, 2, dtype=torch.int32),
                  torch.ones(2, 2, dtype=torch.int32), w=8, n=3)


@pytest.mark.parametrize("w", [11, 12, 13, 14])
def test_max_exact_k_boundary_brute_force(w):
    """At K = max_exact_k(w) all-max unsigned operands are exact for KMM
    and MM; at K + 1 the true product passes int32 and the carrier wraps,
    bit for bit as the reference's does."""
    k = kmm.max_exact_k(w)
    assert k == jax_kmm.max_exact_k(w)
    hi = 2 ** w - 1
    for kk in (k, k + 1):
        a = np.full((3, kk), hi, np.int32)
        b = np.full((kk, 2), hi, np.int32)
        ref64 = a.astype(np.int64) @ b.astype(np.int64)
        for name in ("kmm_n", "mm_n"):
            got = getattr(kmm, name)(torch.from_numpy(a),
                                     torch.from_numpy(b), w=w, n=2)
            _same(got, getattr(jax_kmm, name)(jnp.array(a), jnp.array(b),
                                              w=w, n=2), f"{name} K={kk}")
            exact = np.array_equal(got.numpy().astype(np.int64), ref64)
            assert exact == (kk == k), (name, kk)
            np.testing.assert_array_equal(
                got.numpy(), (ref64 & 0xFFFFFFFF).astype(np.uint32)
                .astype(np.int32))


def test_max_exact_k_values():
    for w in range(1, 20):
        assert kmm.max_exact_k(w) == jax_kmm.max_exact_k(w)
    assert kmm.max_exact_k(8) == 2 ** 15 and kmm.max_exact_k(16) == 0


def test_kmm_matmul_stacked_and_batched_match_jax():
    rng = np.random.default_rng(5)
    a = _rand(rng, -2 ** 11, 2 ** 11, (2, 3, 5, 40))
    b2 = _rand(rng, -2 ** 11, 2 ** 11, (40, 6))
    bb = _rand(rng, -2 ** 11, 2 ** 11, (2, 3, 40, 6))
    for b in (b2, bb):
        for combine in (None, "float32"):
            got = kmm.kmm_matmul(torch.from_numpy(a), torch.from_numpy(b),
                                 w=12, n=2,
                                 combine_dtype=combine and torch.float32)
            _same(got, jax_kmm.kmm_matmul(
                jnp.array(a), jnp.array(b), 12, 2,
                combine and jnp.float32), f"b {b.shape} {combine}")
            assert tuple(got.shape) == (2, 3, 5, 6)


@pytest.mark.parametrize("p,groups", [(1, 3), (2, 5), (4, 4), (8, 2),
                                      (8, 8)])
def test_preaccum_matmul_matches_jax(p, groups):
    rng = np.random.default_rng(p * 10 + groups)
    k = p * groups
    for lo, hi in ((-2 ** 7, 2 ** 7), (0, 2 ** 8)):
        a = _rand(rng, lo, hi, (5, k))
        b = _rand(rng, lo, hi, (k, 7))
        got = accum.preaccum_matmul(torch.from_numpy(a), torch.from_numpy(b),
                                    p=p)
        _same(got, jax_accum.preaccum_matmul(jnp.array(a), jnp.array(b),
                                             p=p))
        np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                      a.astype(np.int64) @ b.astype(np.int64))
    with pytest.raises(ValueError):
        accum.preaccum_matmul(torch.zeros(2, 6, dtype=torch.int32),
                              torch.zeros(6, 2, dtype=torch.int32), p=4)


def test_preaccum_mm1_as_the_leaf_hook():
    """Algorithm 5 as Algorithms 3/4's MM_1: bit-identical to the flat
    leaf, as in the reference."""
    a, b = _operands(12, True, 9, m=6, k=64, n=5)
    for name in ("kmm_n", "mm_n"):
        got = getattr(kmm, name)(torch.from_numpy(a), torch.from_numpy(b),
                                 w=12, n=2, mm1=accum.preaccum_mm1(4))
        ref = getattr(jax_kmm, name)(jnp.array(a), jnp.array(b), w=12, n=2,
                                     mm1=jax_accum.preaccum_mm1(4))
        _same(got, ref, name)
    assert accum.wide_adds_saved(64, 4) == jax_accum.wide_adds_saved(64, 4)


@pytest.mark.parametrize("shape", [(8, 64, 8), (3, 10, 5)])
def test_ffip_literal_matches_jax(shape):
    m, k, n = shape
    rng = np.random.default_rng(k)
    a = _rand(rng, -128, 128, (m, k))
    b = _rand(rng, -128, 128, (k, n))
    got = ffip.ffip_gemm_literal(torch.from_numpy(a), torch.from_numpy(b))
    _same(got, jax_ffip.ffip_gemm_literal(jnp.array(a), jnp.array(b)))
    np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                  a.astype(np.int64) @ b.astype(np.int64))
    assert ffip.ffip_mults(m, k, n) == jax_ffip.ffip_mults(m, k, n)
    with pytest.raises(ValueError, match="even K"):
        ffip.ffip_gemm_literal(torch.from_numpy(a[:, :-1]),
                               torch.from_numpy(b[:-1]))


def test_leaf_float64_bound_on_device_tensors():
    """Off the CPU the leaf is a float64 matmul: exact while K *
    2^(2 bits) <= 2^53, else it raises (meta tensors carry the shapes)."""
    def meta(*shape):
        return torch.empty(shape, dtype=torch.int32, device="meta")

    out = kmm.exact_dot(meta(4, 2 ** 21), meta(2 ** 21, 3), bits=16)
    assert out.shape == (4, 3) and out.dtype == torch.int32
    with pytest.raises(ValueError, match="float64 bound"):
        kmm.exact_dot(meta(4, 2 ** 21 + 1), meta(2 ** 21 + 1, 3), bits=16)
    with pytest.raises(ValueError, match="float64 bound"):
        kmm.exact_dot(meta(4, 8), meta(8, 3))     # int32 range: 2^62 each
    # every leaf of the recursion stays inside the bound at w = 28, n = 8
    assert kmm.kmm_n(meta(4, 8192), meta(8192, 16), w=28, n=8).shape == \
        (4, 16)
    # and a depth-0 leaf at w = 28 does not
    with pytest.raises(ValueError, match="float64 bound"):
        kmm.kmm_n(meta(4, 8192), meta(8192, 16), w=28, n=1)
