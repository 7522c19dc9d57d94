"""The split-mode kernel (``csrc/fused_split.cu``: kmm2 at w 9-14, mm2 at
w 15-16) on the CPU: its plan, its split-K arithmetic and its digit-plane
layout.

The plan (``mm1_plan.plan_split``) covers the logical padded K [0, kp)
once, in whole stages but the last, and splits the narrow grids of the
serve path (granite's router, N = 40, one tile) while lm_head's wide grid
runs unsplit.  A plain-PyTorch mirror of the kernel's split-K arithmetic —
each split's int32 digit products and row and column sums over its range
of [0, kp), wrapped modulo 2^32, summed modulo 2^32, then the epilogue in
the kernel's fp32 (or int32-ring) order — must equal
``fused_gemm_reference`` (``torch.equal``) and the JAX Pallas kernel in
interpret mode (``array_equal``), raw and dequantized to fp32 and bf16,
for K not a multiple of ``block_k`` and split boundaries inside [K, kp),
dense and grouped with zero-count experts and full segments.  A numpy
emulation of the kernel's int16 -> s8 plane split (two values a 32-bit
word), its swizzled shared-memory planes and its MMA fragment addressing
(``ldmatrix`` A fragments, 4x4 byte-transposed B fragments,
``mma.m16n8k32``) must give the reference's digit products.  The CUDA
kernel itself is held to the plain version on the card by
``chip_smoke.py``.
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
BN = mm1_plan.BN
MODES = [("kmm2", 9), ("kmm2", 12), ("kmm2", 14), ("mm2", 15), ("mm2", 16)]


# ---------------------------------------------------------------- the plan

@pytest.mark.parametrize("mode", ["kmm2", "mm2"])
@pytest.mark.parametrize("k,block_k", [(70, 8), (300, 256), (1000, 256),
                                       (1536, 256), (2048, 256),
                                       (8960, 256)])
def test_plan_covers_kp_in_whole_stages(mode, k, block_k):
    kp = fg.padded_k(k, block_k)
    for g, m in [(1, 1), (1, 4), (1, 64), (1, 2048), (40, 8), (40, 32)]:
        for n in (17, 40, 512, 8192, 128512):
            plan = mm1_plan.plan_split(mode, g, m, kp, n, H100_SMS)
            ranges = plan.k_ranges()
            assert plan.k == kp and len(ranges) == plan.split >= 1
            assert ranges[0][0] == 0 and ranges[-1][1] == kp
            for (_, e0), (s1, _) in zip(ranges, ranges[1:]):
                assert e0 == s1                          # once, in order
            assert all(e > s for s, e in ranges)         # no empty split
            bk = mm1_plan.SPLIT_BK[plan.bm]          # 32 at 16 rows, 64
            for s, e in ranges[:-1]:
                assert s % bk == 0 and (e - s) % bk == 0
            assert plan.bm == (16 if m <= 64 else 64)
            accs = mm1_plan.SPLIT_ACCS[mode]
            assert plan.tile_ints == accs * plan.bm * BN + plan.bm + BN
            if plan.tiles >= H100_SMS:
                assert plan.split == 1
            if plan.split > 1:
                assert plan.k_split // bk >= mm1_plan.MIN_SPLIT_STAGES
                # partials no more bytes than the split's int16 slice of B
                assert 2 * accs * plan.bm * 4 <= plan.k_split * 2
                assert plan.ws_ints == plan.tiles * plan.split * \
                    plan.tile_ints
                assert plan.n_counters == plan.tiles
            else:
                assert plan.ws_ints == 0 and ranges == [(0, kp)]


@pytest.mark.parametrize("k,n,kmm2_split,mm2_split", [
    (1536, 40, 8, 6), (2048, 128512, 1, 1), (1536, 49664, 1, 1),
    (2560, 65536, 1, 1), (2048, 2048, 10, 8), (2048, 8192, 5, 5),
    (8192, 2048, 16, 16)])
def test_plan_splits_narrow_decode_grids(k, n, kmm2_split, mm2_split):
    """At decode (M=4): granite's router (one tile) splits K six to eight
    ways (kmm2's three accumulators allow shorter splits than mm2's four);
    every lm_head's grid fills the card unsplit; llama's projections at
    w=16 split to about two blocks an SM."""
    for mode, split in (("kmm2", kmm2_split), ("mm2", mm2_split)):
        plan = mm1_plan.plan_split(mode, 1, 4, k, n, H100_SMS)
        assert plan.bm == 16 and plan.split == split


@pytest.mark.parametrize("k,c,split", [(1536, 32, 3), (512, 32, 1),
                                       (1536, 16, 3), (1536, 8, 3),
                                       (8192, 64, 16)])
def test_plan_splits_ragged_grids_that_fill_the_card(k, c, split):
    """granite's expert GEMMs (40 experts) fill the card with tiles, most
    of them dead at decode: a ragged launch still splits K, in pieces of at
    least RAGGED_SPLIT_STAGES stages; the same grid dense does not."""
    for mode in ("kmm2", "mm2"):
        plan = mm1_plan.plan_split(mode, 40, c, k, 512, H100_SMS, True)
        assert plan.tiles >= H100_SMS and plan.split == split
        per = plan.k_split // mm1_plan.SPLIT_BK[plan.bm]
        assert split == 1 or per >= mm1_plan.RAGGED_SPLIT_STAGES
        assert mm1_plan.plan_split(mode, 40, c, k, 512, H100_SMS).split == 1


def test_plan_rule_is_shared_with_mm1():
    """mm1's plan is the same rule with one int8 accumulator."""
    for args in [(1, 4, 2048, 8192), (1, 4, 8960, 2560), (40, 32, 1536, 512),
                 (1, 2048, 2048, 8192)]:
        got = mm1_plan.plan_mm1(*args, H100_SMS)
        want = mm1_plan.plan_split_k(*args, H100_SMS)
        assert got == want and got.tile_ints == got.bm * BN
    with pytest.raises(ValueError):
        mm1_plan.plan_split("kmm2", 1, 0, 64, 8, H100_SMS)


# ------------------------------------------------- the split-K arithmetic

def _wrap(x):
    """int64 -> int64 holding the int32 value modulo 2^32."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x)


def _digit_products(mode, a, b, h, z):
    """The mode's digit products of padded int64 operands (exact int64)."""
    mask = (1 << h) - 1
    a1, a0 = a >> h, (a & mask) - z
    b1, b0 = b >> h, (b & mask) - z
    if mode == "kmm2":
        pairs = [(a1, b1), (a1 + a0, b1 + b0), (a0, b0)]
    else:
        pairs = [(a1, b1), (a1, b0), (a0, b1), (a0, b0)]
    return [x @ y for x, y in pairs]


def split_k_mirror(mode, a, b, sx, sw, plan, *, h, z, kp, combine_int32,
                   out_dtype, counts=None, seg=None):
    """What the kernel computes under ``plan``, in plain PyTorch: over each
    split's range of [0, kp) (A and B zero beyond K) its digit products,
    its raw row sums and its column sums less z a position (the kernel
    takes those from MMAs of ones with the digit planes), each wrapped to
    int32 as its partials are, summed modulo 2^32; then the kernel's
    epilogue and dead rows zeroed."""
    k = a.shape[-1]
    a64 = torch.nn.functional.pad(a.to(torch.int64), (0, kp - k))
    b64 = torch.nn.functional.pad(b.to(torch.int64), (0, 0, 0, kp - k))
    accs = row = col = None
    for s, e in plan.k_ranges():
        parts = [_wrap(p) for p in _digit_products(
            mode, a64[..., s:e], b64[..., s:e, :], h, z)]
        rs = _wrap(a64[..., s:e].sum(-1, keepdim=True))
        cs = _wrap(b64[..., s:e, :].sum(-2, keepdim=True) - (e - s) * z)
        if accs is None:
            accs, row, col = parts, rs, cs
        else:
            accs = [_wrap(x + y) for x, y in zip(accs, parts)]
            row, col = _wrap(row + rs), _wrap(col + cs)
    r = _wrap(row - kp * z)
    c = col
    if combine_int32:
        if mode == "kmm2":
            c1, cs_, c0 = accs
            core = (c1 << (2 * h)) + ((cs_ - c1 - c0) << h) + c0
        else:
            c1, c10, c01, c0 = accs
            core = (c1 << (2 * h)) + ((c10 + c01) << h) + c0
        val = _wrap(core + (z * r + z * c + z * z * kp)).to(torch.int32)
    else:
        f = [x.to(torch.int32).to(torch.float32) for x in accs]
        p2h, ph = float(2 ** (2 * h)), float(2 ** h)
        if mode == "kmm2":
            mid = (f[1] - f[0]) - f[2]
            core = (f[0] * p2h + mid * ph) + f[2]
        else:
            mid = f[1] + f[2]
            core = (f[0] * p2h + mid * ph) + f[3]
        rf = r.to(torch.int32).to(torch.float32)
        cf = c.to(torch.int32).to(torch.float32)
        corr = (rf * float(z) + cf * float(z)) + float(z) * float(z) * \
            float(kp)
        val = core + corr
    if sx is not None:
        val = val.to(torch.float32) * (sx * sw)
    out = val if out_dtype == torch.int32 else val.to(out_dtype)
    if counts is not None:
        live = fg.ragged_row_mask(counts, seg, a.shape[-2])
        out = torch.where(live, out, torch.zeros_like(out))
    return out


def _operands(w, shape_a, shape_b, seed):
    """w-bit codes with rows and columns of +-qmax and, at w=14, -2^13 (the
    pre-adder's -128) beside qmax (its 126)."""
    rng = np.random.default_rng(seed)
    q = 2 ** (w - 1) - 1
    a = rng.integers(-q, q + 1, size=shape_a).astype(np.int16)
    b = rng.integers(-q, q + 1, size=shape_b).astype(np.int16)
    a[..., 0, :], a[..., 1, :] = q, -q
    b[..., :, 0], b[..., :, 1] = q, -q
    if w == 14:
        a[..., 2, ::2] = -2 ** 13
        b[..., ::3, 2] = -2 ** 13
    sx = (rng.random(shape_a[:-1] + (1,), dtype=np.float32) + 0.5) * 1e-2
    sw = (rng.random(shape_b[:-2] + (1, shape_b[-1]), dtype=np.float32)
          + 0.5) * 1e-2
    return a, b, sx, sw


OUTS = [("raw", False, None, None), ("raw_int32", True, None, None),
        ("f32", False, torch.float32, jnp.float32),
        ("bf16", False, torch.bfloat16, jnp.bfloat16),
        ("bf16_int32", True, torch.bfloat16, jnp.bfloat16)]


def _out_dtype(label, ci, out_t):
    if out_t is not None:
        return out_t
    return torch.int32 if ci else torch.float32


# (m, k, n, block_k, num_sms, what): kp > K with a split boundary inside
# (K, kp) and the last split wholly in [K, kp) ("pad"); a last split that
# straddles K; granite's router (N=40, K=1536) as the card splits it; the
# 64-row tile split; and the unaligned 5 x 300 x 130 shape unsplit.
SPLIT_CASES = [(3, 1560, 100, 256, 3, "pad"), (5, 1100, 40, 256, 3, "split"),
               (4, 1536, 40, 256, H100_SMS, "split"),
               (65, 2100, 40, 256, 4, "split"),
               (5, 300, 130, 32, H100_SMS, "none")]


@pytest.mark.parametrize("m,k,n,block_k,num_sms,what", SPLIT_CASES)
@pytest.mark.parametrize("mode,w", MODES, ids=[f"{m}{w}" for m, w in MODES])
def test_split_mirror_matches_reference_and_jax(mode, w, m, k, n, block_k,
                                                num_sms, what):
    a, b, sx, sw = _operands(w, (m, k), (k, n), seed=w * 1000 + m + n)
    _, h, z, _ = fg.resolve(w, mode=mode)
    kp = fg.padded_k(k, block_k)
    plan = mm1_plan.plan_split(mode, 1, m, kp, n, num_sms)
    ranges = plan.k_ranges()
    assert (plan.split > 1) == (what != "none") and ranges[-1][1] == kp
    if what == "pad":
        assert kp > k and k < ranges[-1][0] < kp
    if w == 14:
        pre = (a >> h) + ((a & ((1 << h) - 1)) - z)
        assert pre.min() == -128 and pre.max() == 126
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for label, ci, out_t, out_j in OUTS:
        scales = out_t is not None
        tsx = torch.from_numpy(sx) if scales else None
        tsw = torch.from_numpy(sw) if scales else None
        want_t = _out_dtype(label, ci, out_t)
        got = split_k_mirror(mode, ta, tb, tsx, tsw, plan, h=h, z=z, kp=kp,
                             combine_int32=ci, out_dtype=want_t)
        ref = fg.fused_gemm_reference(ta, tb, tsx, tsw, mode=mode, h=h,
                                      z=z, kp=kp, combine_int32=ci,
                                      out_dtype=want_t)
        assert got.dtype == ref.dtype == want_t
        assert torch.equal(got, ref), label
        # the wrapper's CPU route is that same plain version
        assert torch.equal(fg.fused_gemm(ta, tb, tsx, tsw, w=w, mode=mode,
                                         block_k=block_k, combine_int32=ci,
                                         out_dtype=out_t), ref)
        jref = jax_fused_gemm(jnp.asarray(a), jnp.asarray(b),
                              jnp.asarray(sx) if scales else None,
                              jnp.asarray(sw) if scales else None, w=w,
                              mode=mode, out_dtype=out_j, interpret=True,
                              block_m=32, block_n=64, block_k=block_k,
                              combine_int32=ci)
        np.testing.assert_array_equal(got.to(torch.float32).numpy(),
                                      np.asarray(jref.astype(jnp.float32)))


# grouped: expert 0 partial segments, expert 1 zero tokens (no live row),
# expert 2 full segments, expert 3 one live row in its last segment
G_COUNTS = np.array([[2, 0, 5], [0, 0, 0], [6, 6, 6], [0, 0, 1]], np.int32)
G_SEG = 6


@pytest.mark.parametrize("mode,w", [("kmm2", 12), ("kmm2", 14),
                                    ("mm2", 16)])
def test_grouped_split_mirror_matches_reference_and_jax(mode, w):
    e, c, k, n = 4, 20, 1000, 40
    a, b, sx, sw = _operands(w, (e, c, k), (e, k, n), seed=w)
    _, h, z, _ = fg.resolve(w, mode=mode)
    kp = fg.padded_k(k, 256)
    plan = mm1_plan.plan_split(mode, e, c, kp, n, 16)
    assert plan.split > 1 and plan.bm == 16 and plan.tiles_m == 2
    ta, tb, tc = (torch.from_numpy(x) for x in (a, b, G_COUNTS))
    live = fg.ragged_row_mask(tc, G_SEG, c)[..., 0]
    assert live[2, :18].all() and not live[2, 18:].any()
    for label, ci, out_t, out_j in OUTS:
        scales = out_t is not None
        tsx = torch.from_numpy(sx) if scales else None
        tsw = torch.from_numpy(sw) if scales else None
        want_t = _out_dtype(label, ci, out_t)
        got = split_k_mirror(mode, ta, tb, tsx, tsw, plan, h=h, z=z, kp=kp,
                             combine_int32=ci, out_dtype=want_t, counts=tc,
                             seg=G_SEG)
        ref = fg.fused_gemm_grouped_reference(
            ta, tb, tsx, tsw, tc, seg=G_SEG, mode=mode, h=h, z=z, kp=kp,
            combine_int32=ci, out_dtype=want_t)
        assert torch.equal(got, ref), label
        assert not got[~live].any() and not got[1].any()
        jref = jax_grouped(jnp.asarray(a), jnp.asarray(b),
                           jnp.asarray(sx) if scales else None,
                           jnp.asarray(sw) if scales else None,
                           jnp.asarray(G_COUNTS), w=w, mode=mode, seg=G_SEG,
                           out_dtype=out_j, interpret=True, block_m=8,
                           block_n=16, block_k=256, combine_int32=ci)
        np.testing.assert_array_equal(got.to(torch.float32).numpy(),
                                      np.asarray(jref.astype(jnp.float32)))


def test_split_mirror_wraps_like_one_pass():
    """Digit products and row sums past 2^31 wrap modulo 2^32; per-split
    wrapping and a modular sum give the one-pass int32 value."""
    w, mode, k = 16, "mm2", 140_000
    _, h, z, _ = fg.resolve(w, mode=mode)
    a = torch.full((2, k), 2 ** 15 - 1, dtype=torch.int16)
    a[1] = -(2 ** 15 - 1)
    b = torch.full((k, 3), 2 ** 15 - 1, dtype=torch.int16)
    plan = mm1_plan.plan_split(mode, 1, 2, k, 3, 132)
    assert plan.split > 1
    for ci in (False, True):
        out_t = torch.int32 if ci else torch.float32
        got = split_k_mirror(mode, a, b, None, None, plan, h=h, z=z, kp=k,
                             combine_int32=ci, out_dtype=out_t)
        ref = fg.fused_gemm_reference(a, b, None, None, mode=mode, h=h, z=z,
                                      kp=k, combine_int32=ci,
                                      out_dtype=out_t)
        assert torch.equal(got, ref)
    assert 127 * 127 * k > 2 ** 31 and (2 ** 15 - 1) * k > 2 ** 31


# -------------------------------- the plane split and fragment addressing

def _split8_words(words, h, z, mode):
    """The kernel's split8 on uint32 words of two int16 (numpy uint32
    arrays (..., 4)): 8 bytes a plane, as two uint32 words."""
    mask2 = np.uint32(((1 << h) - 1) * 0x10001)
    zc2 = np.uint32((256 - z) * 0x10001)
    hi = words >> np.uint32(h)                  # bytes 0 and 2 are read
    if mode == "kmm2":
        hi = hi & np.uint32(0x00FF00FF)         # the pre-adder adds it
    lo = (words & mask2) + zc2                  # byte 1 is 0 or 1
    planes = [hi] + ([hi + lo] if mode == "kmm2" else []) + [lo]

    def pack(x):
        # __byte_perm(x0, x1, 0x6420): bytes 0 and 2 of each word
        def two(x0, x1):
            return ((x0 & 0xFF) | ((x0 >> 16) & 0xFF) << 8
                    | (x1 & 0xFF) << 16 | ((x1 >> 16) & 0xFF) << 24)
        return np.stack([two(x[..., 0], x[..., 1]),
                         two(x[..., 2], x[..., 3])], axis=-1)
    return [pack(p).astype(np.uint32) for p in planes]


def _bytes_of(words):
    return words.astype("<u4").view(np.uint8)


def _byte_perm(x, y, s):
    src = np.concatenate([_bytes_of(np.atleast_1d(x)).reshape(-1, 4),
                          _bytes_of(np.atleast_1d(y)).reshape(-1, 4)], 1)
    sel = [(s >> (4 * i)) & 7 for i in range(4)]
    out = src[:, sel].copy()
    return out.view("<u4").reshape(-1)


def _transpose4x4(w):
    x0 = _byte_perm(w[0], w[1], 0x5140)
    x1 = _byte_perm(w[0], w[1], 0x7362)
    y0 = _byte_perm(w[2], w[3], 0x5140)
    y1 = _byte_perm(w[2], w[3], 0x7362)
    return [_byte_perm(x0, y0, 0x5410), _byte_perm(x0, y0, 0x7632),
            _byte_perm(x1, y1, 0x5410), _byte_perm(x1, y1, 0x7632)]


def _s8(words):
    """uint32 words (lanes,) -> (lanes, 4) signed bytes."""
    return _bytes_of(words).reshape(-1, 4).view(np.int8).astype(np.int64)


def emulate_block(mode, a, b, h, z, kp, bm):
    """One block of the kernel, in numpy: carrier stages of A (bm, bk) and
    B (bk, BN) (zero beyond K; bk the tile's stage depth), split into the
    swizzled s8 planes by the kernel's thread mapping, then every warp's fragments and m16n8k32 MMAs
    as the PTX fragment layouts define them, with the column-sum MMAs (an
    A of ones below kp in rows 0-7 times the high plane, in rows 8-15 times
    the low plane).  Returns the (NACC, bm, BN) int64 accumulators at their
    tile positions, the row sums and each column's sum less kp z."""
    k = a.shape[1]
    bk = mm1_plan.SPLIT_BK[bm]
    nplane = 3 if mode == "kmm2" else 2
    nacc = 3 if mode == "kmm2" else 4
    warps_m = bm // 32 if bm >= 32 else 1
    mt_n = bm // 16 // warps_m
    nthreads = 128 * warps_m
    a_pitch = bk + 16
    n_st = -(-kp // bk)
    acc = np.zeros((nacc, bm, BN), np.int64)
    rows = np.zeros(bm, np.int64)
    csum = np.zeros((2, BN), np.int64)          # high and low digit sums
    for st in range(n_st):
        k0 = st * bk
        ca = np.zeros((bm, bk), np.int16)
        cb = np.zeros((bk, BN), np.int16)
        kk_end = min(k, k0 + bk)
        if kk_end > k0:
            ca[:a.shape[0], :kk_end - k0] = a[:, k0:kk_end]
            cb[:kk_end - k0, :b.shape[1]] = b[k0:kk_end]
        rows += ca.astype(np.int64).sum(1)
        a_planes = np.zeros((nplane, bm * a_pitch), np.uint8)
        b_planes = np.zeros((nplane, bk * BN), np.uint8)
        a_chunks = ca.reshape(-1, 8).view(np.uint32)          # (chunks, 4)
        b_chunks = cb.reshape(-1, 8).view(np.uint32)
        for tid in range(nthreads):
            for i in range(-(-bm * bk // 8 // nthreads)):
                c = tid + i * nthreads
                if c >= bm * bk // 8:
                    break
                r, kc = c // (bk // 8), c % (bk // 8)
                d = _split8_words(a_chunks[c], h, z, mode)
                keep = min(max(kp - (k0 + kc * 8), 0), 8)
                for q in range(nplane):
                    by = _bytes_of(d[q]).copy()
                    by[keep:] = 0
                    a_planes[q, r * a_pitch + kc * 8:
                             r * a_pitch + kc * 8 + 8] = by
            for i in range(bk * BN // 8 // nthreads):
                c = tid + i * nthreads
                r, cc = c // 16, c % 16
                d = _split8_words(b_chunks[c], h, z, mode)
                off = r * BN + (((cc >> 1) ^ (2 * ((r >> 2) & 3))) * 16) \
                    + (cc & 1) * 8
                for q in range(nplane):
                    b_planes[q, off:off + 8] = _bytes_of(d[q])
        if mode == "kmm2":
            prods = [(0, 0, 0), (1, 1, 1), (2, 2, 2)]
        else:
            prods = [(qa, qb, 2 * qa + qb) for qa in (0, 1) for qb in (0, 1)]
        lanes = np.arange(32)
        g, t = lanes >> 2, lanes & 3
        for warp in range(4 * warps_m):
            wm, wn = warp // 4, warp % 4
            col = (((2 * wn + (g >> 2)) ^ (2 * t)) * 16) + (g & 3) * 4
            for kk in range(0, bk, 32):
                for qa, qb, q in prods:
                    bf = []
                    for hh in (0, 1):
                        w = [b_planes[qb][((kk + 16 * hh + 4 * t + i) * BN
                                           + col)[:, None] + np.arange(4)]
                             .copy().view("<u4").reshape(-1)
                             for i in range(4)]
                        bf.append(_transpose4x4(w))
                    if qa == qb and qb in (0, nplane - 1) and wm == 0:
                        # the ones MMA: high plane into rows 0-7, low 8-15
                        ones = np.zeros((16, 32), np.int64)
                        half = 0 if qb == 0 else 8
                        ones[half:half + 8] = (k0 + kk + np.arange(32)) < kp
                        for j in range(4):
                            bmat = np.zeros((32, 8), np.int64)
                            for hh in (0, 1):
                                vals = _s8(bf[hh][j])
                                for ln in range(32):
                                    bmat[16 * hh + 4 * t[ln]:
                                         16 * hh + 4 * t[ln] + 4, g[ln]] = \
                                        vals[ln]
                            d = ones @ bmat
                            assert (d[half:half + 8] == d[half]).all()
                            csum[qb // (nplane - 1),
                                 32 * wn + 4 * np.arange(8) + j] += d[half]
                    for mt in range(mt_n):
                        # ldmatrix.x4: lane l's row address, matrix i from
                        # lanes 8i..8i+7; thread (g, t) gets word t of row g
                        r0 = (wm * mt_n + mt) * 16
                        amat = np.zeros((16, 32), np.int64)
                        for rr in range(16):
                            base = (r0 + rr) * a_pitch + kk
                            amat[rr] = a_planes[qa][base:base + 32].view(
                                np.int8)
                        af = []
                        for qq in range(4):
                            lrow = r0 + g + 8 * (qq % 2)
                            addr = (lrow * a_pitch + kk + 16 * (qq // 2)
                                    + 4 * t)
                            af.append(a_planes[qa][addr[:, None]
                                                   + np.arange(4)]
                                      .copy().view("<u4").reshape(-1))
                        # the MMA's A (16 x 32) from the fragments
                        am = np.zeros((16, 32), np.int64)
                        for qq in range(4):
                            vals = _s8(af[qq])
                            for ln in range(32):
                                am[g[ln] + 8 * (qq % 2),
                                   16 * (qq // 2) + 4 * t[ln]:
                                   16 * (qq // 2) + 4 * t[ln] + 4] = vals[ln]
                        assert np.array_equal(am, amat)
                        for j in range(4):
                            bm_ = np.zeros((32, 8), np.int64)
                            for hh in (0, 1):
                                vals = _s8(bf[hh][j])
                                for ln in range(32):
                                    bm_[16 * hh + 4 * t[ln]:
                                        16 * hh + 4 * t[ln] + 4, g[ln]] = \
                                        vals[ln]
                            d = am @ bm_                      # (16, 8)
                            # MMA column c is tile column 32 wn + 4c + j
                            acc[q][r0:r0 + 16,
                                   32 * wn + 4 * np.arange(8) + j] += d
    return acc, rows, (csum[0] << h) + csum[1]


@pytest.mark.parametrize("mode,w,m,k,n,block_k,bm", [
    ("kmm2", 14, 5, 130, 70, 32, 16),      # kp = 160: a ragged last stage
    ("kmm2", 9, 16, 64, 128, 64, 16),
    ("mm2", 16, 3, 100, 128, 128, 16),     # kp = 128: padding split
    ("kmm2", 12, 40, 70, 128, 8, 64),      # the 64-row tile, 8 warps
    ("mm2", 15, 33, 64, 50, 64, 64)])
def test_plane_split_and_fragments_give_the_digit_products(mode, w, m, k, n,
                                                           block_k, bm):
    a, b, _, _ = _operands(w, (m, k), (k, n), seed=k + n)
    _, h, z, _ = fg.resolve(w, mode=mode)
    kp = fg.padded_k(k, block_k)
    acc, rows, cols = emulate_block(mode, a, b, h, z, kp, bm)
    a64 = np.zeros((bm, kp), np.int64)
    b64 = np.zeros((kp, BN), np.int64)
    a64[:m, :k], b64[:k, :n] = a, b
    want = _digit_products(mode, torch.from_numpy(a64),
                           torch.from_numpy(b64), h, z)
    for q, p in enumerate(want):
        np.testing.assert_array_equal(acc[q], p.numpy())
    np.testing.assert_array_equal(rows, a64.sum(1))
    np.testing.assert_array_equal(cols, b64.sum(0) - kp * z)
    # the byte split is the reference's digit split, value by value
    v = np.arange(-2 ** (w - 1), 2 ** (w - 1), dtype=np.int16)
    v = v[: len(v) // 8 * 8]
    planes = _split8_words(v.reshape(-1, 8).view(np.uint32), h, z, mode)
    got = [_bytes_of(p).reshape(-1).view(np.int8) for p in planes]
    v64 = v.astype(np.int64)
    hi, lo = v64 >> h, (v64 & ((1 << h) - 1)) - z
    want = [hi] + ([hi + lo] if mode == "kmm2" else []) + [lo]
    for g_, w_ in zip(got, want):
        np.testing.assert_array_equal(g_.astype(np.int64), w_)
