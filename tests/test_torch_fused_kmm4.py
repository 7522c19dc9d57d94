"""The fused GEMM's kmm4 mode (``csrc/fused_split.cu``, layout KMM4: int32
carrier, six leaf planes, exact split-K) on the CPU: its plan, its digit
split and fragment path, its split-K arithmetic and its column sums.

The plan (``mm1_plan.plan_split("kmm4", ...)``) covers the logical padded
K [0, kp) once, in whole 32-deep stages but the last, splits the narrow
decode grids (llama's 2048 x 2048 at M=4 seven ways) and the ragged expert
grids, and is the rule mm1 and the other split modes use, with nine
accumulators and 4-byte carriers.  A numpy emulation of one block — the
kernel's int32 -> six s8 leaf planes split (branches formed in 32 bits,
packed two a word as 16-bit lanes), its swizzled shared-memory planes and
its MMA fragments (``ldmatrix`` A, 4x4 byte-transposed B, ``m16n8k32``) —
must give the reference's nine branch products through the cross-product
identity Cs = C1 + (x1.y0 + x0.y1) + C0, at every width of the window with
+-qmax, -2^(w-1) and +2^25 edges and K ending inside [K, kp).  A
plain-PyTorch mirror of the split-K arithmetic (per split: the nine int32
accumulators and the raw row and column sums, wrapped and summed modulo
2^32; then the epilogue) must equal ``fused_gemm_reference`` and the JAX
Pallas kernel in interpret mode, dense and ragged grouped, raw, fp32, bf16
and int32 ring.  The splitting threads' column sums must wrap as the
reference's int32 sum does.  The CUDA kernel itself is held to the plain
version on the card by ``chip_smoke.py``.
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
from test_torch_fused_split import (_byte_perm, _bytes_of, _s8,  # noqa: E402
                                    _transpose4x4)

H100_SMS = 132
BN = mm1_plan.BN
WIDTHS = [9, 12, 16, 17, 20, 22, 23, 24, 26]


def _h2(h):
    return (h + 2) // 2                 # ceil((h + 1) / 2)


# ---------------------------------------------------------------- the plan

@pytest.mark.parametrize("k,block_k", [(70, 8), (300, 256), (1000, 256),
                                       (1536, 256), (2048, 256),
                                       (8960, 256)])
def test_kmm4_plan_covers_kp_in_whole_stages(k, block_k):
    kp = fg.padded_k(k, block_k)
    for g, m in [(1, 1), (1, 4), (1, 64), (1, 65), (1, 2048), (40, 8),
                 (40, 32)]:
        for n in (17, 40, 512, 8192, 128512):
            plan = mm1_plan.plan_split("kmm4", g, m, kp, n, H100_SMS)
            ranges = plan.k_ranges()
            assert plan.k == kp and len(ranges) == plan.split >= 1
            assert ranges[0][0] == 0 and ranges[-1][1] == kp
            for (_, e0), (s1, _) in zip(ranges, ranges[1:]):
                assert e0 == s1                          # once, in order
            assert all(e > s for s, e in ranges)         # no empty split
            # one m16 a warp; 32 rows where M > 16 and N spans two tiles
            assert plan.bm == (32 if m > 16 and n > BN else 16)
            bk = mm1_plan.SPLIT_BK[plan.bm]
            assert bk == 32
            for s, e in ranges[:-1]:
                assert s % bk == 0 and (e - s) % bk == 0
            assert plan.tile_ints == 9 * plan.bm * BN + plan.bm + BN
            if plan.tiles >= H100_SMS:
                assert plan.split == 1
            if plan.split > 1:
                assert plan.k_split // bk >= mm1_plan.MIN_SPLIT_STAGES
                # partials no more bytes than the split's int32 slice of B
                assert 2 * 9 * plan.bm * 4 <= plan.k_split * 4
                assert plan.ws_ints == plan.tiles * plan.split * \
                    plan.tile_ints
                assert plan.n_counters == plan.tiles
            else:
                assert plan.ws_ints == 0 and ranges == [(0, kp)]


@pytest.mark.parametrize("k,n,split", [
    (2048, 2048, 7), (2048, 512, 7), (2048, 8192, 5), (8192, 2048, 16),
    (1536, 40, 5), (2048, 128512, 1), (1536, 49664, 1), (2560, 65536, 1)])
def test_kmm4_plan_splits_narrow_decode_grids(k, n, split):
    """At decode (M=4): llama's 2048 x 2048 (16 tiles) splits seven ways,
    each split at least nine stages deep (its partials, 2 x 9 x 16 x 128
    int32, no more bytes than its int32 slice of B); every lm_head's grid
    fills the card unsplit."""
    plan = mm1_plan.plan_split("kmm4", 1, 4, k, n, H100_SMS)
    assert plan.bm == 16 and plan.split == split
    if split > 1:
        assert plan.k_split // 32 >= 9


@pytest.mark.parametrize("k,c,split", [(1536, 32, 3), (512, 32, 1),
                                       (1536, 16, 3), (1536, 8, 3),
                                       (8192, 64, 16)])
def test_kmm4_plan_splits_ragged_grids_that_fill_the_card(k, c, split):
    plan = mm1_plan.plan_split("kmm4", 40, c, k, 512, H100_SMS, True)
    assert plan.tiles >= H100_SMS and plan.split == split
    per = plan.k_split // mm1_plan.SPLIT_BK[plan.bm]
    assert split == 1 or per >= mm1_plan.RAGGED_SPLIT_STAGES
    assert mm1_plan.plan_split("kmm4", 40, c, k, 512, H100_SMS).split == 1


def test_kmm4_plan_rule_is_shared():
    """kmm4's plan is mm1's rule with nine accumulators, int32 carriers,
    the row and column sums and its own tiles — 16 rows at decode, for
    ragged launches and for one column tile (the router), 32 rows else;
    the workspace holds every split's partials and sums of every tile."""
    for g, m, k, n, ragged, bm in [(1, 4, 2048, 2048, False, 16),
                                   (1, 16, 2048, 128512, False, 16),
                                   (1, 17, 2048, 128512, False, 32),
                                   (1, 64, 2048, 8192, False, 32),
                                   (1, 64, 1536, 40, False, 16),
                                   (1, 2048, 2048, 8192, False, 32),
                                   (40, 32, 1536, 512, True, 16)]:
        assert mm1_plan.split_tile_rows("kmm4", m, n, ragged) == bm
        got = mm1_plan.plan_split("kmm4", g, m, k, n, H100_SMS, ragged)
        want = mm1_plan.plan_split_k(g, m, k, n, H100_SMS, accs=9,
                                     carrier_bytes=4, sums=True, bk=32,
                                     ragged=ragged, bm=bm)
        assert got == want and got.bm == bm
        assert got.ws_ints == (got.tiles * got.split
                               * (9 * bm * BN + bm + BN)
                               if got.split > 1 else 0)
    # the same rule with kmm2's three accumulators and int16 carriers
    assert mm1_plan.plan_split("kmm2", 1, 4, 2048, 2048, H100_SMS) == \
        mm1_plan.plan_split_k(1, 4, 2048, 2048, H100_SMS, accs=3,
                              carrier_bytes=2, sums=True, bk=32)
    with pytest.raises(ValueError):
        mm1_plan.plan_split("kmm4", 1, 0, 64, 8, H100_SMS)


# ----------------------------------------- the leaf split and the fragments

def _split4_kmm4(words, h, z):
    """The kernel's split4_kmm4 on uint32 words (n, 4) of int32 values:
    six planes, one uint32 word (4 bytes in value order) each, (n,)."""
    h2 = _h2(h)
    w = words.astype(np.uint32)
    hi = (w.view(np.int32) >> h).view(np.uint32)      # arithmetic shift
    lo = (w & np.uint32((1 << h) - 1)) - np.uint32(z)
    mask2x = np.uint32(((1 << h2) - 1) * 0x10001)
    planes = []
    for x in (hi, hi + lo, lo):
        p0 = _byte_perm(x[:, 0], x[:, 1], 0x5410)
        p1 = _byte_perm(x[:, 2], x[:, 3], 0x5410)
        planes.append(_byte_perm(p0 >> np.uint32(h2), p1 >> np.uint32(h2),
                                 0x6420))
        planes.append(_byte_perm(p0 & mask2x, p1 & mask2x, 0x6420))
    return planes


def _leaves(x, h):
    """The reference's depth-2 digits of int64 codes: for each branch of
    (A1, A1 + A0bar, A0bar) its plain h2 split (x1, x0)."""
    h2, z = _h2(h), 1 << (h - 1)
    hi, lo = x >> h, (x & ((1 << h) - 1)) - z
    return [(br >> h2, br & ((1 << h2) - 1)) for br in (hi, hi + lo, lo)]


def _b_matrix(words):
    """The (32, 8) B operand of an m16n8k32 MMA from the lanes' two
    fragment words each (PTX layout: lane (g, t) holds column g, k rows
    4t..4t+3 and 16+4t..16+4t+3)."""
    lanes = np.arange(32)
    g, t = lanes >> 2, lanes & 3
    bm = np.zeros((32, 8), np.int64)
    for hh in (0, 1):
        bm[16 * hh + 4 * t[:, None] + np.arange(4), g[:, None]] = \
            _s8(words[hh])
    return bm


def emulate_kmm4_block(a, b, h, kp, bm):
    """One block of the kmm4 kernel, in numpy: carrier stages of A (bm, 32)
    and B (32, BN) int32 (zero beyond K), split by the kernel's thread
    mapping into the six swizzled leaf planes (A's digits at k >= kp
    zeroed), then every warp's fragments and MMAs as the PTX layouts define
    them.  Returns the (9, bm, BN) int64 accumulators at their tile
    positions (per branch high.high, the two cross products, low.low), the
    raw row sums and the column sums the splitting threads keep (4 columns
    a thread, reduced over the threads that share them), uint32."""
    z = 1 << (h - 1)
    k = a.shape[1]
    bk = mm1_plan.SPLIT_BK[bm]
    nt = 128 * (bm // 16)
    a_pitch = bk + 16
    lanes = np.arange(32)
    g, t = lanes >> 2, lanes & 3
    acc = np.zeros((9, bm, BN), np.int64)
    rows = np.zeros(bm, np.uint32)
    cols_t = np.zeros((nt, 4), np.uint32)       # each thread's 4 columns
    for k0 in range(0, kp, bk):
        ca = np.zeros((bm, bk), np.int32)
        cb = np.zeros((bk, BN), np.int32)
        kk_end = min(k, k0 + bk)
        if kk_end > k0:
            ca[:a.shape[0], :kk_end - k0] = a[:, k0:kk_end]
            cb[:kk_end - k0, :b.shape[1]] = b[k0:kk_end]
        # A: chunk c (thread c) is row c // (bk / 4), k-chunk c % (bk / 4)
        a_words = ca.reshape(-1, 4).view(np.uint32)
        c = np.arange(len(a_words))
        r, kc = c // (bk // 4), c % (bk // 4)
        np.add.at(rows, r, a_words.sum(1, dtype=np.uint32))
        keep = np.clip(kp - (k0 + 4 * kc), 0, 4).astype(np.uint64)
        m = ((np.uint64(1) << (np.uint64(8) * keep)) - np.uint64(1)) \
            .astype(np.uint32)
        a_planes = np.zeros((6, bm * a_pitch), np.uint8)
        for q, d in enumerate(_split4_kmm4(a_words, h, z)):
            a_planes[q][(r * a_pitch + 4 * kc)[:, None] + np.arange(4)] = \
                _bytes_of(d & m).reshape(-1, 4)
        # B: chunk c = tid + nt i is row c // 32, column chunk c % 32
        b_words = cb.reshape(-1, 4).view(np.uint32)
        c = np.arange(len(b_words))
        r, cc = c // 32, c % 32
        np.add.at(cols_t, c % nt, b_words)
        off = r * BN + (((cc >> 2) ^ (2 * ((r >> 2) & 3))) * 16) \
            + (cc & 3) * 4
        b_planes = np.zeros((6, bk * BN), np.uint8)
        for q, d in enumerate(_split4_kmm4(b_words, h, z)):
            b_planes[q][off[:, None] + np.arange(4)] = \
                _bytes_of(d).reshape(-1, 4)
        for warp in range(nt // 32):
            wm, wn = warp // 4, warp % 4
            r0 = wm * 16
            col = (((2 * wn + (g >> 2)) ^ (2 * t)) * 16) + (g & 3) * 4
            for kk in range(0, bk, 32):
                for q in range(3):
                    bfr = {}
                    for leaf in (0, 1):
                        plane = b_planes[2 * q + leaf]
                        halves = []
                        for hh in (0, 1):
                            w = [plane[((kk + 16 * hh + 4 * t + i) * BN
                                        + col)[:, None] + np.arange(4)]
                                 .copy().view("<u4").reshape(-1)
                                 for i in range(4)]
                            halves.append(_transpose4x4(w))
                        bfr[leaf] = [_b_matrix([halves[0][j], halves[1][j]])
                                     for j in range(4)]
                    afr = {}
                    for leaf in (0, 1):
                        plane = a_planes[2 * q + leaf]
                        am = np.zeros((16, 32), np.int64)
                        for qq in range(4):
                            # ldmatrix.x4: thread (g, t) gets word t of row
                            # g of matrix qq (rows + 8 (qq % 2), k + 16
                            # (qq // 2))
                            addr = ((r0 + g + 8 * (qq % 2)) * a_pitch + kk
                                    + 16 * (qq // 2) + 4 * t)
                            words = plane[addr[:, None] + np.arange(4)] \
                                .copy().view("<u4").reshape(-1)
                            am[g[:, None] + 8 * (qq % 2),
                               16 * (qq // 2) + 4 * t[:, None]
                               + np.arange(4)] = _s8(words)
                        afr[leaf] = am
                    for la, lb, idx in ((0, 0, 3 * q), (0, 1, 3 * q + 1),
                                        (1, 0, 3 * q + 1),
                                        (1, 1, 3 * q + 2)):
                        for j in range(4):
                            # MMA column c is tile column 32 wn + 4c + j
                            acc[idx][r0:r0 + 16,
                                     32 * wn + 4 * np.arange(8) + j] += \
                                afr[la] @ bfr[lb][j]
    cols = np.zeros(BN, np.uint32)
    for tid in range(nt):
        cols[4 * (tid % 32) + np.arange(4)] += cols_t[tid]
    return acc, rows, cols


def _edge_operands(w, m, k, n, seed):
    """w-bit int32 codes with rows and columns of +qmax, -qmax and
    -2^(w-1), and at w=26 the quantizer's +2^25 (one past qmax)."""
    rng = np.random.default_rng(seed)
    q = 2 ** (w - 1) - 1
    a = rng.integers(-q, q + 1, size=(m, k)).astype(np.int32)
    b = rng.integers(-q, q + 1, size=(k, n)).astype(np.int32)
    a[0], a[1 % m] = q, -q
    b[:, 0], b[:, 1 % n] = q, -q
    a[-1, ::2] = -2 ** (w - 1)
    b[::3, -1] = -2 ** (w - 1)
    if w == 26:
        a[-1, 1::2] = 2 ** 25
        b[1::3, -1] = 2 ** 25
        b[2::3, 2 % n] = 2 ** 25
    return a, b


# (m, k, n, block_k, bm): K ends inside [K, kp) and kp inside the last
# stage (A's digits at k >= kp forced to 0); kp a whole stage past K; the
# 32-row tile's eight warps
EMU_CASES = [(5, 70, 70, 8, 16), (16, 100, 128, 32, 16),
             (20, 70, 100, 64, 32)]


@pytest.mark.parametrize("m,k,n,block_k,bm", EMU_CASES)
@pytest.mark.parametrize("w", WIDTHS)
def test_leaf_planes_and_fragments_give_the_branch_products(w, m, k, n,
                                                            block_k, bm):
    a, b = _edge_operands(w, m, k, n, seed=w * 100 + k)
    _, h, z, carrier = fg.resolve(w, mode="kmm4")
    assert carrier == torch.int32
    kp = fg.padded_k(k, block_k)
    assert kp > k or block_k == 32
    acc, rows, cols = emulate_kmm4_block(a, b, h, kp, bm)
    a64 = np.zeros((bm, kp), np.int64)
    b64 = np.zeros((kp, BN), np.int64)
    a64[:m, :k], b64[:k, :n] = a, b
    for q, ((x1, x0), (y1, y0)) in enumerate(zip(_leaves(a64, h),
                                                 _leaves(b64, h))):
        np.testing.assert_array_equal(acc[3 * q], x1 @ y1)
        np.testing.assert_array_equal(acc[3 * q + 1], x1 @ y0 + x0 @ y1)
        np.testing.assert_array_equal(acc[3 * q + 2], x0 @ y0)
        # the cross-product identity gives the reference's pre-adder pass
        np.testing.assert_array_equal(
            acc[3 * q] + acc[3 * q + 1] + acc[3 * q + 2],
            (x1 + x0) @ (y1 + y0))
    np.testing.assert_array_equal(rows, a64.sum(1).astype(np.uint32))
    np.testing.assert_array_equal(cols, b64.sum(0).astype(np.uint32))


@pytest.mark.parametrize("w", WIDTHS)
def test_leaf_split_is_the_reference_digit_split(w):
    """Value by value (every value for w <= 16, a sample and the edges
    above), the six leaf bytes are the reference's depth-2 digits and fit
    s8: high leaves in [-64, 63], low ones in [0, 127]."""
    _, h, z, _ = fg.resolve(w, mode="kmm4")
    top = 2 ** (w - 1)
    if w <= 16:
        v = np.arange(-top, top + 1, dtype=np.int64)
    else:
        rng = np.random.default_rng(w)
        v = np.concatenate([rng.integers(-top, top + 1, 1 << 16),
                            [-top, -top + 1, -1, 0, 1, top - 1, top]])
    if w == 26:
        assert top == 2 ** 25 and top in v
    v = np.concatenate([v, np.zeros(-len(v) % 4, np.int64)])
    words = v.astype(np.int32).reshape(-1, 4).view(np.uint32)
    got = [_bytes_of(p).reshape(-1).view(np.int8).astype(np.int64)
           for p in _split4_kmm4(words, h, z)]
    for q, (x1, x0) in enumerate(_leaves(v, h)):
        np.testing.assert_array_equal(got[2 * q], x1)
        np.testing.assert_array_equal(got[2 * q + 1], x0)
        assert -64 <= x1.min() and x1.max() <= 63
        assert 0 <= x0.min() and x0.max() <= 127


# ------------------------------------------------- the split-K arithmetic

def _wrap(x):
    """int64 -> int64 holding the int32 value modulo 2^32."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x)


def _nine(a, b, h):
    """The kernel's nine accumulators of padded int64 operands (exact
    int64): per branch high.high, both cross products, low.low."""
    out = []
    for (x1, x0), (y1, y0) in zip(_leaves(a, h), _leaves(b, h)):
        out += [x1 @ y1, x1 @ y0 + x0 @ y1, x0 @ y0]
    return out


def kmm4_split_k_mirror(a, b, sx, sw, plan, *, h, z, kp, combine_int32,
                        out_dtype, counts=None, seg=None):
    """What the kmm4 kernel computes under ``plan``, in plain PyTorch: over
    each split's range of [0, kp) (A and B zero beyond K) its nine
    accumulators and its raw row and column sums, each wrapped to int32 as
    its partials are, summed modulo 2^32; then the epilogue — Cs = C1 +
    cross + C0 per branch modulo 2^32, the level-2 combine at h2, the
    level-1 combine at h, the correction with both sums less kp z — and
    dead rows zeroed."""
    h2 = _h2(h)
    k = a.shape[-1]
    a64 = torch.nn.functional.pad(a.to(torch.int64), (0, kp - k))
    b64 = torch.nn.functional.pad(b.to(torch.int64), (0, 0, 0, kp - k))
    accs = row = col = None
    for s, e in plan.k_ranges():
        parts = [_wrap(p) for p in _nine(a64[..., s:e], b64[..., s:e, :], h)]
        rs = _wrap(a64[..., s:e].sum(-1, keepdim=True))
        cs = _wrap(b64[..., s:e, :].sum(-2, keepdim=True))
        if accs is None:
            accs, row, col = parts, rs, cs
        else:
            accs = [_wrap(x + y) for x, y in zip(accs, parts)]
            row, col = _wrap(row + rs), _wrap(col + cs)
    for q in range(3):
        accs[3 * q + 1] = _wrap(accs[3 * q] + accs[3 * q + 1]
                                + accs[3 * q + 2])
    r, c = _wrap(row - kp * z), _wrap(col - kp * z)
    if combine_int32:
        def kmm2(c1, cs_, c0, sh):
            return _wrap((c1 << (2 * sh)) + ((cs_ - c1 - c0) << sh) + c0)
        core = kmm2(*(kmm2(*accs[i:i + 3], h2) for i in (0, 3, 6)), h)
        val = _wrap(core + (z * r + z * c + z * z * kp)).to(torch.int32)
    else:
        def kmm2(c1, cs_, c0, sh):
            mid = (cs_ - c1) - c0
            return (c1 * float(2 ** (2 * sh)) + mid * float(2 ** sh)) + c0
        f = [x.to(torch.int32).to(torch.float32) for x in accs]
        core = kmm2(*(kmm2(*f[i:i + 3], h2) for i in (0, 3, 6)), h)
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


OUTS = [("raw", False, None, None), ("raw_int32", True, None, None),
        ("f32", False, torch.float32, jnp.float32),
        ("bf16", False, torch.bfloat16, jnp.bfloat16),
        ("bf16_int32", True, torch.bfloat16, jnp.bfloat16)]


def _scales(rng, shape_a, shape_b):
    sx = (rng.random(shape_a[:-1] + (1,), dtype=np.float32) + 0.5) * 1e-2
    sw = (rng.random(shape_b[:-2] + (1, shape_b[-1]), dtype=np.float32)
          + 0.5) * 1e-2
    return sx, sw


def _jax_labels(w, kp):
    """The outputs the JAX kernel computes at this width and kp: its int32
    ring takes z^2 kp as an int32 constant and refuses one that does not
    fit (w >= 23 at these K)."""
    z = fg.resolve(w, mode="kmm4")[2]
    return [label for label, ci, *_ in OUTS
            if not ci or z * z * kp < 2 ** 31]


def _check_outputs(a, b, sx, sw, plan, w, block_k, jax_labels, *,
                   counts=None, seg=None):
    """The mirror against the reference (every output) and JAX (outputs
    in ``jax_labels``)."""
    _, h, z, _ = fg.resolve(w, mode="kmm4")
    kp = fg.padded_k(a.shape[-1], block_k)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    tc = torch.from_numpy(counts) if counts is not None else None
    for label, ci, out_t, out_j in OUTS:
        scales = out_t is not None
        tsx = torch.from_numpy(sx) if scales else None
        tsw = torch.from_numpy(sw) if scales else None
        want_t = out_t or (torch.int32 if ci else torch.float32)
        kw = dict(h=h, z=z, kp=kp, combine_int32=ci, out_dtype=want_t)
        got = kmm4_split_k_mirror(ta, tb, tsx, tsw, plan, counts=tc, seg=seg,
                                  **kw)
        if counts is None:
            ref = fg.fused_gemm_reference(ta, tb, tsx, tsw, mode="kmm4",
                                          **kw)
            cpu = fg.fused_gemm(ta, tb, tsx, tsw, w=w, mode="kmm4",
                                block_k=block_k, combine_int32=ci,
                                out_dtype=out_t)
        else:
            ref = fg.fused_gemm_grouped_reference(ta, tb, tsx, tsw, tc,
                                                  seg=seg, mode="kmm4", **kw)
            cpu = fg.fused_gemm_grouped(ta, tb, tsx, tsw, tc, w=w,
                                        mode="kmm4", seg=seg,
                                        block_k=block_k, combine_int32=ci,
                                        out_dtype=out_t)
            live = fg.ragged_row_mask(tc, seg, a.shape[-2])[..., 0]
            assert not got[~live].any()
        assert got.dtype == ref.dtype == want_t
        assert torch.equal(got, ref), label
        assert torch.equal(cpu, ref), label      # the wrapper's CPU route
        if label not in jax_labels:
            continue
        jkw = dict(w=w, mode="kmm4", out_dtype=out_j, interpret=True,
                   block_k=block_k, combine_int32=ci)
        jsx = jnp.asarray(sx) if scales else None
        jsw = jnp.asarray(sw) if scales else None
        if counts is None:
            jref = jax_fused_gemm(jnp.asarray(a), jnp.asarray(b), jsx, jsw,
                                  block_m=32, block_n=64, **jkw)
        else:
            jref = jax_grouped(jnp.asarray(a), jnp.asarray(b), jsx, jsw,
                               jnp.asarray(counts), seg=seg, block_m=8,
                               block_n=16, **jkw)
        np.testing.assert_array_equal(got.to(torch.float32).numpy(),
                                      np.asarray(jref.astype(jnp.float32)))


# (m, k, n, block_k, num_sms, what): the last split wholly in [K, kp)
# ("pad"); a last split that straddles K; granite's router (N=40, K=1536)
# as the card splits it; the 32-row tile split three ways; 5 x 300 x 130
# unsplit (N not a multiple of 4: element loads on the card)
SPLIT_CASES = [(3, 1560, 100, 256, 3, "pad"), (5, 1100, 40, 256, 3, "split"),
               (4, 1536, 40, 256, H100_SMS, "split"),
               (65, 2100, 200, 256, 8, "split"),
               (5, 300, 130, 32, H100_SMS, "none")]


@pytest.mark.parametrize("case", range(len(SPLIT_CASES)))
@pytest.mark.parametrize("w", WIDTHS)
def test_kmm4_split_mirror_matches_reference_and_jax(w, case):
    m, k, n, block_k, num_sms, what = SPLIT_CASES[case]
    a, b = _edge_operands(w, m, k, n, seed=w * 1000 + m + n)
    sx, sw = _scales(np.random.default_rng(w), (m, k), (k, n))
    kp = fg.padded_k(k, block_k)
    plan = mm1_plan.plan_split("kmm4", 1, m, kp, n, num_sms)
    ranges = plan.k_ranges()
    assert (plan.split > 1) == (what != "none") and ranges[-1][1] == kp
    assert plan.bm == (32 if m > 16 and n > BN else 16)
    if what == "pad":
        assert kp > k and k < ranges[-1][0] < kp
    # JAX in interpret mode on one output a case, a different one at each
    # case of a width, so every output it takes meets it at every width
    labels = _jax_labels(w, kp)
    label = labels[(case + WIDTHS.index(w)) % len(labels)]
    _check_outputs(a, b, sx, sw, plan, w, block_k, {label})


# grouped: expert 0 partial segments, expert 1 zero tokens (no live row),
# expert 2 full segments, expert 3 one live row in its last segment
G_COUNTS = np.array([[2, 0, 5], [0, 0, 0], [6, 6, 6], [0, 0, 1]], np.int32)
G_SEG = 6


@pytest.mark.parametrize("w", [12, 20, 24, 26])
def test_kmm4_grouped_split_mirror_matches_reference_and_jax(w):
    e, c, k, n = 4, 20, 1000, 40
    rng = np.random.default_rng(w)
    q = 2 ** (w - 1) - 1
    a = rng.integers(-q, q + 1, size=(e, c, k)).astype(np.int32)
    b = rng.integers(-q, q + 1, size=(e, k, n)).astype(np.int32)
    a[:, 0], b[:, :, 0] = -2 ** (w - 1), q
    sx, sw = _scales(rng, (e, c, k), (e, k, n))
    kp = fg.padded_k(k, 256)
    plan = mm1_plan.plan_split("kmm4", e, c, kp, n, 16)
    assert plan.split > 1 and plan.bm == 16 and plan.tiles_m == 2
    _check_outputs(a, b, sx, sw, plan, w, 256, set(_jax_labels(w, kp)),
                   counts=G_COUNTS, seg=G_SEG)


def test_splitter_column_sums_wrap_like_the_reference():
    """At w=24, K=8192: B columns of +-2^22 sum past 2^31; the sums the
    splitting threads keep (each its 4 columns over its rows of every
    stage, reduced over the 4 threads that share them) wrap modulo 2^32
    as the reference's int32 sum does, and the whole mirror — split 26
    ways at M=4 on a 2-tile grid — equals the reference."""
    w, k, n = 24, 8192, 256
    _, h, z, _ = fg.resolve(w, mode="kmm4")
    rng = np.random.default_rng(24)
    q = 2 ** (w - 1) - 1
    a = rng.integers(-q, q + 1, size=(4, k)).astype(np.int32)
    b = rng.integers(-q, q + 1, size=(k, n)).astype(np.int32)
    a[0], a[1] = 2 ** 22, -2 ** 22
    b[:, 0], b[:, 1], b[::2, 2] = 2 ** 22, -2 ** 22, 2 ** 22
    nt = 128
    got = np.zeros(n, np.uint32)
    bw = b.view(np.uint32)
    for tile in range(n // BN):
        for tid in range(nt):
            # stage st, chunk tid + 128 i: row 32 st + tid // 32 + 4 i
            rows = (32 * np.arange(k // 32)[:, None] + tid // 32
                    + 4 * np.arange(8)).reshape(-1)
            cols = tile * BN + 4 * (tid % 32) + np.arange(4)
            got[cols] += bw[rows][:, cols].sum(0, dtype=np.uint32)
    exact = b.astype(np.int64).sum(0)
    assert abs(exact[0]) >= 2 ** 31 and abs(exact[1]) >= 2 ** 31
    want = fg._wrap_int32(torch.from_numpy(exact)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want)
    sx, sw = _scales(rng, (4, k), (k, n))
    plan = mm1_plan.plan_split("kmm4", 1, 4, k, n, H100_SMS)
    assert plan.split == 26
    _check_outputs(a, b, sx, sw, plan, w, 256, set())
