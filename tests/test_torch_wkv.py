"""The port's WKV recurrence (repro_torch.kernels.wkv_gemm) against the JAX
reference: ``wkv_apply`` against JAX's ``wkv_apply`` in interpret mode and
its oracle ``wkv_reference``, at the reference test's shapes and chunks;
the stateful entry against the reference model's per-step scan
(``repro.models.rwkv``) from a nonzero state, and split runs against one.

On the CPU the wrappers run their plain versions (no launch is counted);
``chip_smoke.py`` holds the CUDA kernel to them on the card.

Tolerances: both sides compute in float32, the sum over i of each step in
their own order, so they agree to rounding; the reference's own test gates
the kernel at a max error relative to the output's largest value of 1e-5
(``REL_TOL``), and the stateful comparisons use ``rtol = atol = 1e-5``.
Split runs equal one run exactly (the same steps on the same values).

The CUDA kernel (``csrc/wkv.cu``) splits each step's sum over i across G
lanes and adds their partials by a shuffle butterfly; a numpy emulation of
that order (fused multiply-adds, the butterfly's pairwise tree) at G = 2,
4, 8, 16 and at the kernel's own G for each head size is held to the same
tolerance against ``wkv_reference``, JAX's ``wkv_apply`` and the stateful
plain version.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.wkv_gemm import wkv_apply as jax_wkv_apply  # noqa: E402
from repro.kernels.wkv_gemm import wkv_reference as jax_wkv_reference  # noqa: E402,E501
from repro_torch.kernels import wkv_gemm  # noqa: E402

REL_TOL = 1e-5
RTOL = ATOL = 1e-5


def _streams(rng, shape):
    """r, k, v, w as the reference test makes them."""
    r, k, v = (rng.standard_normal(shape).astype(np.float32) * 0.5
               for _ in range(3))
    w = rng.uniform(0.8, 0.999, shape).astype(np.float32)
    return r, k, v, w


def _rel_err(got, ref):
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-6)


@pytest.mark.parametrize("bh,s,d,chunk", [(4, 64, 16, 16), (2, 33, 8, 32),
                                          (8, 128, 64, 64), (1, 7, 4, 4)])
def test_wkv_apply_matches_jax(bh, s, d, chunk):
    rng = np.random.default_rng(bh * 100 + s)
    r, k, v, w = _streams(rng, (bh, s, d))
    u = rng.standard_normal((bh, d)).astype(np.float32) * 0.1
    wkv_gemm.reset_launches()
    got = wkv_gemm.wkv_apply(*map(torch.from_numpy, (r, k, v, w, u)),
                             chunk=chunk).numpy()
    assert wkv_gemm.launches["wkv"] == 0          # CPU: plain version
    jargs = tuple(map(jnp.asarray, (r, k, v, w, u)))
    ref_kernel = np.asarray(jax_wkv_apply(*jargs, chunk=chunk,
                                          interpret=True))
    ref_oracle = np.asarray(jax_wkv_reference(*jargs))
    assert got.shape == (bh, s, d) and got.dtype == np.float32
    assert _rel_err(got, ref_kernel) < REL_TOL
    assert _rel_err(got, ref_oracle) < REL_TOL


def test_chunk_invariance():
    """chunk does not change the result (the state stays on chip for the
    whole sequence), as the reference's chunks do not."""
    rng = np.random.default_rng(0)
    r, k, v = (rng.standard_normal((2, 32, 8)).astype(np.float32) * 0.3
               for _ in range(3))
    w = rng.uniform(0.9, 0.999, (2, 32, 8)).astype(np.float32)
    u = rng.standard_normal((2, 8)).astype(np.float32) * 0.1
    args = tuple(map(torch.from_numpy, (r, k, v, w, u)))
    y8 = wkv_gemm.wkv_apply(*args, chunk=8).numpy()
    y32 = wkv_gemm.wkv_apply(*args, chunk=32).numpy()
    y1 = wkv_gemm.wkv_apply(*args, chunk=1).numpy()
    np.testing.assert_array_equal(y8, y32)
    np.testing.assert_array_equal(y8, y1)
    ref = np.asarray(jax_wkv_apply(*map(jnp.asarray, (r, k, v, w, u)),
                                   chunk=8, interpret=True))
    np.testing.assert_allclose(y8, ref, rtol=RTOL, atol=ATOL)


def _model_scan(r, k, v, w, u, state0):
    """The reference model's recurrence (``repro/models/rwkv.py``'s scan
    step, :135-140) over (B, S, H, D) streams from ``state0``."""
    def step(state, xs_t):
        rt, kt, vt, wt = xs_t
        kv = kt[..., :, None] * vt[..., None, :]
        yt = jnp.einsum("bhi,bhij->bhj", rt, state + u[None, :, :, None] * kv)
        return wt[..., :, None] * state + kv, yt

    xs = tuple(jnp.moveaxis(jnp.asarray(t), 1, 0) for t in (r, k, v, w))
    state, y = jax.lax.scan(step, jnp.asarray(state0), xs)
    return np.asarray(jnp.moveaxis(y, 0, 1)), np.asarray(state)


def _stateful_inputs(seed, b=2, s=20, h=3, d=16):
    rng = np.random.default_rng(seed)
    r, k, v, w = _streams(rng, (b, s, h, d))
    u = rng.standard_normal((h, d)).astype(np.float32) * 0.1
    state0 = rng.standard_normal((b, h, d, d)).astype(np.float32) * 0.2
    return r, k, v, w, u, state0


@pytest.mark.parametrize("s,d", [(1, 16), (20, 16), (9, 64)])
def test_stateful_matches_model_scan(s, d):
    r, k, v, w, u, state0 = _stateful_inputs(s, s=s, d=d)
    y_ref, st_ref = _model_scan(r, k, v, w, jnp.asarray(u), state0)
    y, st = wkv_gemm.wkv_stateful(*map(torch.from_numpy,
                                       (r, k, v, w, u, state0)))
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(st.numpy(), st_ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("split", [1, 7, 19])
def test_stateful_split_equals_one_run(split):
    """Steps 0..t, then t..S from the carried state, equal one run."""
    r, k, v, w, u, state0 = map(torch.from_numpy, _stateful_inputs(1))
    y, st = wkv_gemm.wkv_stateful(r, k, v, w, u, state0)
    y1, st1 = wkv_gemm.wkv_stateful(r[:, :split], k[:, :split],
                                    v[:, :split], w[:, :split], u, state0)
    y2, st2 = wkv_gemm.wkv_stateful(r[:, split:].contiguous(),
                                    k[:, split:].contiguous(),
                                    v[:, split:].contiguous(),
                                    w[:, split:].contiguous(), u, st1)
    np.testing.assert_array_equal(torch.cat([y1, y2], 1).numpy(), y.numpy())
    np.testing.assert_array_equal(st2.numpy(), st.numpy())


def test_stateful_in_place_and_apply_layout():
    """``inplace`` writes the final state into the given tensor (and leaves
    the input alone otherwise); with H = 1, a per-row bonus and a zero
    state the stateful entry is ``wkv_apply``."""
    r, k, v, w, u, state0 = map(torch.from_numpy, _stateful_inputs(2))
    keep = state0.clone()
    y, st = wkv_gemm.wkv_stateful(r, k, v, w, u, state0)
    assert torch.equal(state0, keep)
    buf = state0.clone()
    y2, st2 = wkv_gemm.wkv_stateful(r, k, v, w, u, buf, inplace=True)
    assert st2 is buf and torch.equal(buf, st) and torch.equal(y2, y)

    bh, s, d = 6, 12, 8
    rng = np.random.default_rng(3)
    a = [torch.from_numpy(x) for x in _streams(rng, (bh, s, d))]
    ub = torch.from_numpy(rng.standard_normal((bh, d)).astype(np.float32))
    y_apply = wkv_gemm.wkv_apply(*a, ub)
    y_st, _ = wkv_gemm.wkv_stateful(*(t[:, :, None] for t in a), ub[:, None],
                                    torch.zeros((bh, 1, d, d)))
    np.testing.assert_array_equal(y_st[:, :, 0].numpy(), y_apply.numpy())


def test_wrappers_refuse_what_the_kernel_does_not_take():
    """The same contract on the CPU as on the card: float32, one stride
    pattern with D contiguous, a supported head size, a contiguous state,
    at least one step."""
    r, k, v, w, u, state0 = map(torch.from_numpy, _stateful_inputs(4))
    with pytest.raises(TypeError):
        wkv_gemm.wkv_stateful(r.double(), k, v, w, u, state0)
    with pytest.raises(ValueError, match="strides"):
        wkv_gemm.wkv_stateful(r[:, ::2], k[:, ::2].contiguous(),
                              v[:, ::2].contiguous(),
                              w[:, ::2].contiguous(), u, state0)
    with pytest.raises(ValueError, match="state"):
        wkv_gemm.wkv_stateful(r, k, v, w, u, state0.transpose(2, 3))
    with pytest.raises(ValueError, match="at least one"):
        wkv_gemm.wkv_stateful(r[:, :0], k[:, :0], v[:, :0], w[:, :0], u,
                              state0)
    with pytest.raises(ValueError, match="head size"):
        wkv_gemm.wkv_apply(*(torch.zeros((2, 4, 12)) for _ in range(4)),
                           torch.zeros((2, 12)))
    with pytest.raises(ValueError, match="chunk"):
        wkv_gemm.wkv_apply(*(torch.zeros((2, 4, 16)) for _ in range(4)),
                           torch.zeros((2, 16)), chunk=0)


# ------------------------------------------- the kernel's split-sum order

# csrc/wkv.cu's sum split by head size: G lanes of D / G rows each form a
# partial y[j]; G as its Cfg<D, STEP> sets it (R = D / G rows a lane), for
# the chunked kernel (S > 1) and the decode kernel (S = 1).
KERNEL_G = {4: (4, 4), 8: (4, 4), 16: (8, 8), 64: (16, 8)}


def _fma(a, b, c):
    """fp32 fused multiply-add (the kernel's ``__fmaf_rn``): the product
    exact in float64, one rounding to float32 after the add (float64's own
    rounding of the sum first: a double rounding that differs from a true
    fma in the last bit at most, far inside the tolerance)."""
    return (np.asarray(a, np.float64) * b + c).astype(np.float32)


def emulate_split_sum(r, k, v, w, u, state0, g_count):
    """The kernel's step order on (N, S, D) fp32 streams (N = B H heads),
    (N, D) bonus and (N, D, D) state: lane group g keeps rows g R .. g R +
    R - 1 (R = D / G) and forms each step's partial y[j] over them in order
    of i with fused multiply-adds, reading the old state before updating
    it; the G partials are then summed by the shuffle butterfly (level l
    adds the partial of group g ^ 2^l), which leaves the same sum in every
    group.  Returns (y (N, S, D), final state)."""
    n, s, d = r.shape
    rows = d // g_count
    st = state0.reshape(n, g_count, rows, d).astype(np.float32).copy()
    ur = u.reshape(n, g_count, rows)
    ys = np.zeros((n, s, d), np.float32)
    for t in range(s):
        rt, kt, wt = (x[:, t].reshape(n, g_count, rows) for x in (r, k, w))
        vt = v[:, t][:, None, :]
        part = np.zeros((n, g_count, d), np.float32)
        for rr in range(rows):
            kv = (kt[:, :, rr, None] * vt).astype(np.float32)
            old = st[:, :, rr]
            part = _fma(_fma(ur[:, :, rr, None], kv, old),
                        rt[:, :, rr, None], part)
            st[:, :, rr] = _fma(wt[:, :, rr, None], old, kv)
        lvl = 1
        while lvl < g_count:
            part = (part + part[:, np.arange(g_count) ^ lvl]).astype(
                np.float32)
            lvl <<= 1
        assert (part == part[:, :1]).all()      # every group holds the sum
        ys[:, t] = part[:, 0]
    return ys, st.reshape(n, d, d)


@pytest.mark.parametrize("g_count", [2, 4, 8, 16])
@pytest.mark.parametrize("bh,s,d", [(4, 64, 16), (8, 128, 64)])
def test_split_sum_order_matches_reference_and_jax(g_count, bh, s, d):
    """The split-sum order from a zero state, G = 2 .. 16 groups of rows:
    within 1e-5 of ``wkv_reference`` and of JAX's ``wkv_apply`` in
    interpret mode, on y."""
    rng = np.random.default_rng(g_count * 10 + d)
    r, k, v, w = _streams(rng, (bh, s, d))
    u = rng.standard_normal((bh, d)).astype(np.float32) * 0.1
    y, _ = emulate_split_sum(r, k, v, w, u, np.zeros((bh, d, d), np.float32),
                             g_count)
    ref = wkv_gemm.wkv_reference(*map(torch.from_numpy,
                                      (r, k, v, w, u))).numpy()
    jx = np.asarray(jax_wkv_apply(*map(jnp.asarray, (r, k, v, w, u)),
                                  chunk=64, interpret=True))
    np.testing.assert_allclose(y, ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(y, jx, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("d", sorted(KERNEL_G))
def test_kernel_split_matches_stateful_reference(d):
    """The kernel's own G at each supported head size, from a nonzero
    state over the serve layout's (B, S, H, D) streams: y and the final
    state within rtol = atol = 1e-5 of ``wkv_stateful_reference`` (the
    chip's gate), over 20 steps (the chunked kernel's G) and one step (the
    decode kernel's)."""
    for s, g_count in zip((20, 1), KERNEL_G[d]):
        r, k, v, w, u, state0 = _stateful_inputs(d + s, b=2, s=s, h=3, d=d)
        b, _, h, _ = r.shape
        y_ref, st_ref = wkv_gemm.wkv_stateful_reference(
            *map(torch.from_numpy, (r, k, v, w, u, state0)))

        def heads(x):                  # (B, S, H, D) -> (B H, S, D)
            return np.ascontiguousarray(x.transpose(0, 2, 1, 3)).reshape(
                b * h, s, d)

        y, st = emulate_split_sum(*(heads(x) for x in (r, k, v, w)),
                                  np.broadcast_to(u, (b, h, d)).reshape(
                                      b * h, d),
                                  state0.reshape(b * h, d, d), g_count)
        np.testing.assert_allclose(
            y.reshape(b, h, s, d).transpose(0, 2, 1, 3), y_ref.numpy(),
            rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(st.reshape(b, h, d, d), st_ref.numpy(),
                                   rtol=RTOL, atol=ATOL)
