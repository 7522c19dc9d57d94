"""The mm1 kernel's tile and split-K plan (repro_torch.kernels.mm1_plan) and
the split-K arithmetic, on the CPU.

The plan: the splits cover [0, K) once, each a whole number of stages but
the last; the 16-row tile through M=64 and the 64-row tile above; no
split where the tile grid already fills the SMs; the workspace sized to
one int32 tile a split.  The arithmetic: a plain-PyTorch mirror of what
the kernel does with a plan — int32 partials per split, wrapped modulo
2^32, summed modulo 2^32, then the epilogue — must equal
``fused_gemm_reference`` in mode mm1 and the JAX Pallas kernel in
interpret mode (``torch.equal`` / ``array_equal``), raw and dequantized to
fp32 and bf16, dense and grouped with zero-count experts and full
segments.  The CUDA kernel itself is held to the plain version on the
card by ``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.fused_gemm import fused_gemm as jax_fused_gemm  # noqa: E402
from repro.kernels.fused_gemm import \
    fused_gemm_grouped as jax_grouped  # noqa: E402
from repro_torch.kernels import fused_gemm as fg  # noqa: E402
from repro_torch.kernels import mm1_plan  # noqa: E402

H100_SMS = 132
PLAN_K = [70, 300, 1536, 2048, 8192, 8960]
PLAN_M = [1, 4, 16, 64, 2048]
PLAN_G = [1, 40]


@pytest.mark.parametrize("m", PLAN_M)
@pytest.mark.parametrize("k", PLAN_K)
def test_plan_covers_k_in_whole_stages(k, m):
    for g in PLAN_G:
        for n in (17, 512, 2560, 8192):
            plan = mm1_plan.plan_mm1(g, m, k, n, H100_SMS)
            ranges = plan.k_ranges()
            assert len(ranges) == plan.split >= 1
            assert ranges[0][0] == 0 and ranges[-1][1] == k
            for (s0, e0), (s1, _) in zip(ranges, ranges[1:]):
                assert e0 == s1                          # once, in order
            for s, e in ranges:
                assert e > s                             # no empty split
            for s, e in ranges[:-1]:
                assert s % mm1_plan.BK == 0 and (e - s) % mm1_plan.BK == 0
            # the tile: 16 rows at decode and serve prefill, 64 above
            assert plan.bm == (16 if m <= mm1_plan.DECODE_MAX_M else 64)
            assert plan.bm == (16 if m <= 64 else 64)
            assert plan.tiles_m == -(-m // plan.bm)
            assert plan.tiles_n == -(-n // mm1_plan.BN)
            assert plan.tiles == g * plan.tiles_m * plan.tiles_n
            if plan.tiles >= H100_SMS:
                assert plan.split == 1                   # grid fills the card
            if plan.split > 1:
                per = plan.k_split // mm1_plan.BK
                assert per >= mm1_plan.MIN_SPLIT_STAGES
                assert plan.k_split >= 8 * plan.bm
                assert plan.blocks <= (mm1_plan.BLOCKS_PER_SM * H100_SMS
                                       + plan.tiles)
                assert plan.ws_ints == (plan.tiles * plan.split * plan.bm
                                        * mm1_plan.BN)
                assert plan.n_counters == plan.tiles
            else:
                assert plan.ws_ints == 0 and plan.n_counters == 0
                assert ranges == [(0, k)]


@pytest.mark.parametrize("k,n,split", [
    (2048, 512, 8), (2048, 2048, 8), (2048, 8192, 5), (8192, 2048, 16),
    (8960, 2560, 14), (2560, 2560, 10), (2560, 8960, 4), (1536, 1536, 6),
    (2048, 128512, 1)])
def test_plan_splits_narrow_decode_grids(k, n, split):
    """At decode (M=4) every dense serve projection but lm_head splits K
    on a 132-SM card, and lm_head's 1,004 tiles need no split."""
    plan = mm1_plan.plan_mm1(1, 4, k, n, H100_SMS)
    assert plan.bm == 16 and plan.split == split
    assert plan.blocks >= min(H100_SMS, plan.tiles * (k // 256))


def test_workspace_tensors_name_what_the_launches_use():
    """A decode graph keeps the split-K workspace its launches captured
    alive through ``workspace_tensors``: it must find the tensors
    ``_workspace`` handed out for the same device and stream, and refuse a
    bare ``cuda`` device, whose missing index names no workspace."""
    plan = mm1_plan.plan_mm1(1, 4, 8192, 512, H100_SMS)
    assert plan.split > 1
    key = (None, -7)
    try:
        ws, counters = fg._workspace(torch.device("cpu"), -7, plan)
        got = fg.workspace_tensors(torch.device("cpu"), -7)
        assert len(got) == 2 and got[0] is ws and got[1] is counters
        assert fg.workspace_tensors(torch.device("cpu"), -8) == ()
        with pytest.raises(ValueError, match="indexed"):
            fg.workspace_tensors(torch.device("cuda"), -7)
    finally:
        fg._WORKSPACE.pop(key, None)


def test_plan_rejects_empty_problems():
    for args in [(0, 4, 64, 8), (1, 0, 64, 8), (1, 4, 64, 0), (1, 4, -1, 8)]:
        with pytest.raises(ValueError):
            mm1_plan.plan_mm1(*args, H100_SMS)


def _wrap(x):
    """int64 -> int32 modulo 2^32."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def split_k_mirror(a, b, sx, sw, plan, out_dtype, counts=None, seg=None):
    """What the kernel computes under ``plan``, in plain PyTorch: each
    split's exact product over its K range, wrapped to int32 as its
    partials are, the partials summed modulo 2^32 in int32, then the
    epilogue (float(acc) * (sx * sw), rounded to the output type) and dead
    rows set to zero."""
    a64, b64 = a.to(torch.int64), b.to(torch.int64)
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.int64)
    for s, e in plan.k_ranges():
        part = _wrap(a64[..., s:e] @ b64[..., s:e, :])
        acc = _wrap(acc + part.to(torch.int64)).to(torch.int64)
    val = acc.to(torch.int32)
    if sx is not None:
        val = val.to(torch.float32) * (sx * sw)
    out = val if out_dtype == torch.int32 else val.to(out_dtype)
    if counts is not None:
        live = fg.ragged_row_mask(counts, seg, a.shape[-2])
        out = torch.where(live, out, torch.zeros_like(out))
    return out


def _operands(shape_a, shape_b, seed, edge=False):
    rng = np.random.default_rng(seed)
    a = rng.integers(-127, 128, size=shape_a).astype(np.int8)
    b = rng.integers(-127, 128, size=shape_b).astype(np.int8)
    if edge:
        # rows and columns of +-127: int32 sums of large magnitude (beyond
        # 2^24, where the float cast rounds)
        a[..., 0, :], a[..., 1, :] = 127, -127
        b[..., :, 0], b[..., :, 1] = 127, 127
    sx = (rng.random(shape_a[:-1] + (1,), dtype=np.float32) + 0.5) * 1e-2
    sw = (rng.random(shape_b[:-2] + (1, shape_b[-1]), dtype=np.float32)
          + 0.5) * 1e-2
    return a, b, sx, sw


OUTS = [("raw", torch.int32, None), ("f32", torch.float32, jnp.float32),
        ("bf16", torch.bfloat16, jnp.bfloat16)]


@pytest.mark.parametrize("m,k,n,num_sms", [
    (3, 1100, 130, 8),       # 4 splits, the last ragged; N ragged
    (5, 1061, 17, 16),       # K and N not multiples of 16
    (65, 1536, 40, 4),       # the 64-row tile, split
    (4, 2050, 200, 132)])    # the unaligned decode shape's K, narrow N
@pytest.mark.parametrize("label,out_t,out_j", OUTS,
                         ids=[o[0] for o in OUTS])
def test_split_mirror_matches_reference_and_jax(m, k, n, num_sms, label,
                                                out_t, out_j):
    a, b, sx, sw = _operands((m, k), (k, n), seed=m * k + n, edge=True)
    plan = mm1_plan.plan_mm1(1, m, k, n, num_sms)
    assert plan.split > 1 and plan.k_ranges()[-1][1] - \
        plan.k_ranges()[-1][0] <= plan.k_split
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    scales = label != "raw"
    tsx = torch.from_numpy(sx) if scales else None
    tsw = torch.from_numpy(sw) if scales else None
    got = split_k_mirror(ta, tb, tsx, tsw, plan, out_t)
    ref = fg.fused_gemm_reference(ta, tb, tsx, tsw, mode="mm1", h=0, z=0,
                                  kp=k, combine_int32=False,
                                  out_dtype=out_t)
    assert got.dtype == ref.dtype == out_t
    assert torch.equal(got, ref), label
    # the wrapper's CPU route is that same plain version
    assert torch.equal(fg.fused_gemm(ta, tb, tsx, tsw, w=8,
                                     out_dtype=out_t if scales else None),
                       ref)
    jref = jax_fused_gemm(jnp.asarray(a), jnp.asarray(b),
                          jnp.asarray(sx) if scales else None,
                          jnp.asarray(sw) if scales else None, w=8,
                          out_dtype=out_j, interpret=True, block_m=32,
                          block_n=32, block_k=256)
    np.testing.assert_array_equal(got.to(torch.float32).numpy(),
                                  np.asarray(jref.astype(jnp.float32)))
    if label == "raw":
        exact = a.astype(np.int64) @ b.astype(np.int64)
        np.testing.assert_array_equal(got.numpy(), exact)
        assert np.abs(exact).max() > 2 ** 24


def test_split_mirror_wraps_like_one_pass():
    """Sums past 2^31 wrap modulo 2^32; per-split wrapping and a modular
    sum give the one-pass int32 value in any split order."""
    k = 140_000                                 # 127 * 127 * k > 2^31
    a = torch.full((2, k), 127, dtype=torch.int8)
    a[1] = -127
    b = torch.full((k, 3), 127, dtype=torch.int8)
    b[:, 2] = torch.tensor([127, -127], dtype=torch.int8).repeat(k // 2)
    plan = mm1_plan.plan_mm1(1, 2, k, 3, 132)
    assert plan.split > 1
    got = split_k_mirror(a, b, None, None, plan, torch.int32)
    ref = fg.fused_gemm_reference(a, b, None, None, mode="mm1", h=0, z=0,
                                  kp=k, combine_int32=False,
                                  out_dtype=torch.int32)
    assert torch.equal(got, ref)
    exact = 127 * 127 * k
    assert exact > 2 ** 31 and int(got[0, 0]) == exact - 2 ** 32
    # arrival order does not matter: the ranges summed in reverse
    rev = torch.zeros_like(got, dtype=torch.int64)
    for s, e in reversed(plan.k_ranges()):
        part = a[:, s:e].to(torch.int64) @ b[s:e].to(torch.int64)
        rev = _wrap(rev + _wrap(part).to(torch.int64)).to(torch.int64)
    assert torch.equal(rev.to(torch.int32), got)


# grouped: expert 0 partial segments, expert 1 zero tokens (no live row),
# expert 2 full segments, expert 3 one live row in its last segment
G_COUNTS = np.array([[2, 0, 5], [0, 0, 0], [6, 6, 6], [0, 0, 1]], np.int32)
G_SEG = 6


@pytest.mark.parametrize("label,out_t,out_j", OUTS,
                         ids=[o[0] for o in OUTS])
def test_grouped_split_mirror_matches_reference_and_jax(label, out_t,
                                                        out_j):
    e, c, k, n = 4, 20, 1100, 40
    a, b, sx, sw = _operands((e, c, k), (e, k, n), seed=7, edge=True)
    plan = mm1_plan.plan_mm1(e, c, k, n, 64)
    assert plan.split > 1 and plan.bm == 16 and plan.tiles_m == 2
    ta, tb, tc = (torch.from_numpy(x) for x in (a, b, G_COUNTS))
    scales = label != "raw"
    tsx = torch.from_numpy(sx) if scales else None
    tsw = torch.from_numpy(sw) if scales else None
    got = split_k_mirror(ta, tb, tsx, tsw, plan, out_t, tc, G_SEG)
    ref = fg.fused_gemm_grouped_reference(
        ta, tb, tsx, tsw, tc, seg=G_SEG, mode="mm1", h=0, z=0, kp=k,
        combine_int32=False, out_dtype=out_t)
    assert torch.equal(got, ref), label
    live = fg.ragged_row_mask(tc, G_SEG, c)[..., 0]
    assert not got[~live].any() and not got[1].any()
    assert live[2, :18].all() and not live[2, 18:].any()
    jref = jax_grouped(jnp.asarray(a), jnp.asarray(b),
                       jnp.asarray(sx) if scales else None,
                       jnp.asarray(sw) if scales else None,
                       jnp.asarray(G_COUNTS), w=8, seg=G_SEG,
                       out_dtype=out_j, interpret=True, block_m=8,
                       block_n=16, block_k=256)
    np.testing.assert_array_equal(got.to(torch.float32).numpy(),
                                  np.asarray(jref.astype(jnp.float32)))
