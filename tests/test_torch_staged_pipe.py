"""The staged digit-plane kernels of ``csrc/staged_pipe.cu`` (``mm1_gemm``,
``kmm_gemm.kmm2_gemm_planes``; ``mm2_gemm.mm2_gemm_planes`` in
``tests/test_torch_staged_mm2.py``) on the CPU: what their wrappers take,
the K-major B planes the staged path now writes, the kernels' split-K
plan, and a numpy emulation of the kernel's data path (mm2's layout too).

  * K-major B: ``mm1_gemm`` and ``kmm2_gemm_planes`` on B planes that are
    ``t.t()`` of contiguous (N, K) tensors (int8 and int16, h 1-7, both
    combines) equal JAX's Pallas kernels in interpret mode, as
    ``tests/test_torch_staged_gemm.py`` runs them, at hostile shapes;
  * ``ops.run_plan`` on every staged numerics class with B row-major, as a
    transposed view and as a K-major carrier view equals JAX's
    ``run_plan``; ``ops`` hands kmm2 and mm2 their planes in B's layout
    (K-major for a K-major B), and copies B only where it pads or casts
    it, in B's layout;
  * ``mm1_plan.plan_staged`` covers K in whole stages, sizes the workspace
    and picks the tile;
  * an emulation of one launch — the ring stages as the copies lay them
    out, the int16 -> s8 narrowing pass, ``ldmatrix`` fragments of A and of
    K-major B, 4x4 byte-transposed fragments of N-major B, the ``__vadd4``
    pre-adder on packed fragments, ``mma.m16n8k32`` as the PTX fragment
    layouts define it, the split-K sum modulo 2^32 and the epilogue's
    combine in fp32 one rounded operation at a time — equals
    ``ref_kmm2_planes`` / ``ref_int_gemm`` / ``ref_mm2_planes``.

The CUDA kernel itself is held to the plain versions on the card by
``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.dispatch import ExecPlan as JaxPlan  # noqa: E402
from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels.kmm_gemm import kmm2_gemm_planes as jax_kmm2  # noqa: E402
from repro.kernels.mm1_gemm import mm1_gemm as jax_mm1  # noqa: E402
from repro_torch.core.dispatch import ExecPlan  # noqa: E402
from repro_torch.kernels import (kmm_gemm, mm1_gemm, mm1_plan,  # noqa: E402
                                 ops, staged_pipe)
from repro_torch.kernels.ref import (ref_int_gemm,  # noqa: E402
                                     ref_kmm2_planes, ref_mm2_planes,
                                     split_planes)

H100_SMS = 132
BN = mm1_plan.BN
RB = mm1_plan.STAGED_ROW_BYTES      # bytes of K a ring stage holds a row
HOSTILE = [(5, 150, 13), (1, 70, 1), (33, 40, 17)]
# A width whose depth-2 branch leaves split at h2 = 1..7 (the int16
# planes of ops._kmm4_core).
W_OF_H2 = {1: 2, 2: 4, 3: 10, 4: 14, 5: 18, 6: 22, 7: 26}


def _rand(w, shape, rng):
    lim = 2 ** (w - 1)
    return rng.integers(-lim, lim, size=shape).astype(np.int32)


def _k_major(x: np.ndarray) -> torch.Tensor:
    """The (K, N) values as ``t.t()`` of a contiguous (N, K) tensor."""
    t = torch.from_numpy(np.ascontiguousarray(x.T)).t()
    assert t.t().is_contiguous()
    return t


def _int8_planes(w, shape_a, shape_b, rng):
    """Centered int8 digit planes at h = ceil(w/2) (ops._planes)."""
    a, b = _rand(w, shape_a, rng), _rand(w, shape_b, rng)
    h = -(-w // 2)
    a1, a0, _ = split_planes(torch.from_numpy(a), h)
    b1, b0, _ = split_planes(torch.from_numpy(b), h)
    return [t.numpy() for t in (a1, a0, b1, b0)], h


def _branch_planes(h2, shape_a, shape_b, rng):
    """The int16 planes of the widest depth-2 branch (A1 + A0bar) at a width
    whose leaves split at ``h2``, as ops._kmm4_core forms them."""
    w = W_OF_H2[h2]
    h = -(-w // 2)
    z = 1 << (h - 1)
    assert -(-(h + 1) // 2) == h2
    out = []
    for shape in (shape_a, shape_b):
        x = _rand(w, shape, rng)
        v = (x >> h) + ((x & ((1 << h) - 1)) - z)
        out += [(v >> h2).astype(np.int16),
                (v & ((1 << h2) - 1)).astype(np.int16)]
    return out, h2


# ------------------------------------------------ K-major B against JAX

@pytest.mark.parametrize("mkn", HOSTILE)
def test_mm1_gemm_k_major_matches_jax(mkn):
    m, k, n = mkn
    rng = np.random.default_rng(k)
    a = _rand(8, (m, k), rng).astype(np.int8)
    b = _rand(8, (k, n), rng).astype(np.int8)
    ref = np.asarray(jax_mm1(jnp.asarray(a), jnp.asarray(b), block_m=m,
                             block_n=n, block_k=k, interpret=True))
    for bt in (torch.from_numpy(b), _k_major(b)):
        got = mm1_gemm.mm1_gemm(torch.from_numpy(a), bt)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), ref)
    assert mm1_gemm.launches["mm1_gemm"] == 0


@pytest.mark.parametrize("mkn", HOSTILE)
@pytest.mark.parametrize("h", range(1, 8))
def test_kmm2_planes_k_major_match_jax(mkn, h):
    """int8 centered planes at w = 2h and int16 branch planes at h2 = h
    (the s8 route through h = 6, the split route at 7), B K-major, both
    combines."""
    m, k, n = mkn
    rng = np.random.default_rng(100 * h + k)
    for planes, hh in (_int8_planes(2 * h, (m, k), (k, n), rng),
                       _branch_planes(h, (m, k), (k, n), rng)):
        jp = [jnp.asarray(p) for p in planes]
        tp = [torch.from_numpy(p) for p in planes[:2]] \
            + [_k_major(p) for p in planes[2:]]
        assert staged_pipe.check_operands("t", tp[:2], tp[2:],
                                          (torch.int8, torch.int16)) \
            == (k > 1 and n > 1)
        for ci in (False, True):
            ref = np.asarray(jax_kmm2(*jp, h=hh, block_m=m, block_n=n,
                                      block_k=k, combine_int32=ci,
                                      interpret=True))
            got = kmm_gemm.kmm2_gemm_planes(*tp, h=hh, combine_int32=ci)
            assert str(ref.dtype) == str(got.dtype).replace("torch.", "")
            np.testing.assert_array_equal(got.numpy(), ref,
                                          err_msg=f"{planes[0].dtype} {ci}")
    assert kmm_gemm.launches == {k: 0 for k in kmm_gemm.launches}


def test_check_operands_takes_row_major_or_k_major_b():
    a = torch.zeros((4, 8), dtype=torch.int8)
    b = torch.zeros((8, 6), dtype=torch.int8)
    bk = torch.zeros((6, 8), dtype=torch.int8).t()
    assert staged_pipe.check_operands("t", [a], [b], (torch.int8,)) is False
    assert staged_pipe.check_operands("t", [a], [bk], (torch.int8,)) is True
    with pytest.raises(ValueError, match="contiguous or K-major"):
        staged_pipe.check_operands("t", [a, a], [b, bk], (torch.int8,))
    strided = torch.zeros((8, 12), dtype=torch.int8)[:, ::2]
    with pytest.raises(ValueError, match="contiguous or K-major"):
        staged_pipe.check_operands("t", [a], [strided], (torch.int8,))
    with pytest.raises(ValueError, match="A plane 0 must be contiguous"):
        staged_pipe.check_operands("t", [a.t().contiguous().t()], [b],
                                   (torch.int8,))


# ------------------------------------------------------ run_plan and ops

def _jax_plan(plan: ExecPlan) -> JaxPlan:
    return JaxPlan(plan.variant, plan.w, plan.m, backend="pallas",
                   block_m=8, block_n=16, block_k=plan.block_k,
                   combine_int32=plan.combine_int32, depth=plan.depth)


def _staged_plans(w):
    """Every staged plan of w's numerics class the staged path runs."""
    if w <= 8:
        return [ExecPlan("mm1", w, block_k=64, combine_int32=True, depth=0)]
    if w <= 14:
        return [ExecPlan("kmm2", w, block_k=64, combine_int32=ci)
                for ci in (False, True)] + [ExecPlan("mm2", w, block_k=64)]
    plans = [ExecPlan("kmm2", w, block_k=64, depth=2)]
    z = 1 << (-(-w // 2) - 1)
    if z * z * 192 < 2 ** 31:       # the reference forms z*z*kp in int32
        plans.append(ExecPlan("kmm2", w, block_k=64, combine_int32=True,
                              depth=2))
    return plans


@pytest.mark.parametrize("w", [8, 12, 14, 20, 22, 23, 24, 26])
def test_run_plan_with_either_b_layout_matches_jax(w):
    """B row-major, as a transposed int32 view and as a K-major view in the
    carrier (which the staged path takes as it is) gives the reference's
    ``run_plan`` result, kernels and mirror."""
    rng = np.random.default_rng(w)
    m, k, n = HOSTILE[0]
    a, b = _rand(w, (m, k), rng), _rand(w, (k, n), rng)
    carrier = (torch.int8 if w <= 8 else torch.int16 if w <= 16
               else torch.int32)
    views = [torch.from_numpy(b), _k_major(b),
             _k_major(b).to(carrier)]
    for plan in _staged_plans(w):
        ref = np.asarray(jax_ops.run_plan_jit(
            jnp.asarray(a), jnp.asarray(b), _jax_plan(plan),
            interpret=True))
        for bt in views:
            for use_ref in (False, True):
                got = ops.run_plan(torch.from_numpy(a), bt, plan=plan,
                                   use_ref_kernels=use_ref)
                np.testing.assert_array_equal(
                    got.numpy(), ref,
                    err_msg=f"{plan} B strides {bt.stride()} {use_ref}")


class _Spy:
    """Records the B planes a kernel wrapper is handed, then runs it."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __call__(self, *args, **kw):
        self.calls.append([t for t in args if isinstance(t, torch.Tensor)])
        return self.fn(*args, **kw)


def _spied(monkeypatch):
    spies = {name: _Spy(getattr(ops, name)) for name in
             ("mm1_gemm", "kmm2_gemm_planes", "mm2_gemm_planes")}
    for name, spy in spies.items():
        monkeypatch.setattr(ops, name, spy)
    return spies


def test_ops_hands_kmm2_planes_in_b_layout_and_mm2_row_major(monkeypatch):
    """kmm2 (depth 1 and the three depth-2 launches) and mm2 get their B
    planes in B's own layout: K-major for a K-major B (the tied lm_head's
    ``embed.T``), padded or not; row-major for a row-major B (mm2's only
    layout before its kernel took K-major B, hence the name)."""
    spies = _spied(monkeypatch)
    rng = np.random.default_rng(5)
    a = torch.from_numpy(_rand(12, (5, 150), rng))
    b = torch.from_numpy(_rand(12, (150, 13), rng))
    for plan in (ExecPlan("kmm2", 12, block_k=64),
                 ExecPlan("kmm2", 12, block_k=64, depth=2),
                 ExecPlan("mm2", 12, block_k=64)):
        ops.run_plan(a, b, plan=plan)
        ops.run_plan(a, b.t().contiguous().t(), plan=plan)
    kmm2 = spies["kmm2_gemm_planes"].calls
    assert len(kmm2) == 2 + 2 * 3
    for i, planes in enumerate(kmm2):
        a_planes, b_planes = planes[:2], planes[2:]
        assert all(t.is_contiguous() for t in a_planes)
        k_major = i in (1, 5, 6, 7)       # the runs on the K-major view
        assert all(t.t().is_contiguous() == k_major
                   and t.is_contiguous() != k_major for t in b_planes)
        assert b_planes[0].shape == (192, 13)
    mm2 = spies["mm2_gemm_planes"].calls
    assert len(mm2) == 2
    for i, planes in enumerate(mm2):
        assert all(t.is_contiguous() for t in planes[:2])
        assert all(t.t().is_contiguous() == (i == 1)
                   and t.is_contiguous() != (i == 1) for t in planes[2:])
        assert planes[2].shape == (192, 13)


def test_ops_copies_b_only_to_pad_or_cast_and_keeps_its_layout(
        monkeypatch):
    """mm1: B in its carrier and padded K goes to the kernel as it is,
    row-major or as a K-major view (the tied lm_head's ``embed.T``: no
    copy); where B must be padded or cast, the copy keeps its layout."""
    spies = _spied(monkeypatch)
    rng = np.random.default_rng(6)
    a = torch.from_numpy(_rand(8, (4, 128), rng)).to(torch.int8)
    plan = ExecPlan("mm1", 8, block_k=64, combine_int32=True, depth=0)
    embed = torch.from_numpy(_rand(8, (40, 128), rng)).to(torch.int8)
    row = embed.t().contiguous()
    short = torch.from_numpy(_rand(8, (40, 100), rng)).to(torch.int8).t()
    for b, copied in ((row, False), (embed.t(), False),
                      (row.to(torch.int32), True),
                      (embed.t().to(torch.int32), True),
                      (short.contiguous(), True), (short, True)):
        aa = a if b.shape[0] == 128 else a[:, :100].contiguous()
        ops.run_plan(aa, b, plan=plan)
        got = spies["mm1_gemm"].calls[-1][1]
        k_major = not b.is_contiguous()
        assert got.t().is_contiguous() == k_major
        assert got.is_contiguous() != k_major
        if not copied:
            assert got.data_ptr() == b.data_ptr()
            continue
        assert got.data_ptr() != b.data_ptr()
        assert got.shape == (128, 40) and got.dtype == torch.int8
        np.testing.assert_array_equal(got[:b.shape[0]].numpy(),
                                      b.numpy().astype(np.int8))
        assert not got[b.shape[0]:].any()


# ------------------------------------------------------------ the plan

@pytest.mark.parametrize("layout,pb", [("mm1", 1), ("kmm2", 1), ("kmm2", 2),
                                       ("kmm2_split", 2)])
@pytest.mark.parametrize("m,k,n", [(4, 2048, 8192), (4, 8192, 2048),
                                   (64, 2048, 8192), (4, 2048, 128512),
                                   (65, 2048, 2048), (2048, 2048, 8192),
                                   (8, 1536, 512), (5, 300, 130),
                                   (1, 70, 1), (4, 1536, 40)])
def test_staged_plan_covers_k_in_whole_stages(layout, pb, m, k, n):
    p = mm1_plan.plan_staged(layout, m, k, n, H100_SMS, pb)
    bk = mm1_plan.STAGED_ROW_BYTES // pb
    accs = mm1_plan.STAGED_ACCS[layout]
    if layout == "mm1":
        assert p.bm == (16 if m <= 64 else 64)
    else:
        assert p.bm == (64 if m > 16 and n > BN else 16)
    assert (p.tiles_m, p.tiles_n) == (-(-m // p.bm), -(-n // BN))
    ranges = p.k_ranges()
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    assert all(e0 == s1 for (_, e0), (s1, _) in zip(ranges, ranges[1:]))
    assert all(e > s for s, e in ranges)                  # no empty split
    if p.split > 1:
        assert p.k_split % bk == 0
        # each split covers at least MIN_SPLIT_STAGES stages and enough K
        # that its partials are no more bytes than its slice of B
        depth = p.k_split
        assert depth >= mm1_plan.MIN_SPLIT_STAGES * bk
        assert depth * pb * mm1_plan.STAGED_PLANES[layout] \
            >= 8 * accs * p.bm
        assert p.tiles < H100_SMS
        # one wave: the split grid fits the blocks the card holds at once
        assert p.blocks <= H100_SMS * mm1_plan.STAGED_BLOCKS_PER_SM[
            (layout, p.bm)]
        assert p.ws_ints == p.tiles * p.split * accs * p.bm * BN
        assert p.n_counters == p.tiles
    else:
        assert p.ws_ints == 0 and p.n_counters == 0
    if p.tiles >= H100_SMS:
        assert p.split == 1


def test_staged_plan_splits_decode_and_takes_a_forced_split():
    # llama's wi at decode: 64 tiles for 132 SMs split 5 ways (mm1, int8)
    p = mm1_plan.plan_staged("mm1", 4, 2048, 8192, H100_SMS, 1)
    assert (p.bm, p.tiles, p.split, p.k_split) == (16, 64, 5, 448)
    # the KMM2 layouts hold two 16-row blocks an SM: 4 splits of 64 tiles
    # fill the 264 slots in one wave (5, the rule's count, would not);
    # int16 planes take 32-value stages
    for layout, pb in (("kmm2", 1), ("kmm2_split", 2)):
        p = mm1_plan.plan_staged(layout, 4, 2048, 8192, H100_SMS, pb)
        assert (p.bm, p.split, p.k_split) == (16, 4, 512)
    # M=64: one 64-row tile a column tile, one block an SM: 2 splits
    p = mm1_plan.plan_staged("kmm2_split", 64, 2048, 8192, H100_SMS, 2)
    assert (p.bm, p.tiles, p.split) == (64, 64, 2)
    # the router (one column tile) keeps the 16-row tile
    assert mm1_plan.plan_staged("kmm2", 64, 1536, 40, H100_SMS, 1).bm == 16
    # lm_head fills the card: no split
    assert mm1_plan.plan_staged("kmm2", 4, 2048, 128512, H100_SMS,
                                1).split == 1
    for forced, want in ((1, 1), (3, 3), (100, 32)):
        p = mm1_plan.plan_staged("kmm2", 4, 2048, 128512, H100_SMS, 1,
                                 split=forced)
        assert p.split == want and p.k_ranges()[-1][1] == 2048
        assert p.ws_ints == (0 if want == 1 else
                             p.tiles * want * 3 * 16 * BN)
    with pytest.raises(ValueError):
        mm1_plan.plan_staged("mm1", 4, 64, 8, H100_SMS, 4)


# ------------------------------------------------- emulation of a launch

def _bytes_of(words):
    return np.asarray(words).astype("<u4").view(np.uint8)


def _byte_perm(x, y, s):
    src = np.concatenate([_bytes_of(np.atleast_1d(x)).reshape(-1, 4),
                          _bytes_of(np.atleast_1d(y)).reshape(-1, 4)], 1)
    sel = [(s >> (4 * i)) & 7 for i in range(4)]
    return src[:, sel].copy().view("<u4").reshape(-1)


def _transpose4x4(w):
    x0 = _byte_perm(w[0], w[1], 0x5140)
    x1 = _byte_perm(w[0], w[1], 0x7362)
    y0 = _byte_perm(w[2], w[3], 0x5140)
    y1 = _byte_perm(w[2], w[3], 0x7362)
    return [_byte_perm(x0, y0, 0x5410), _byte_perm(x0, y0, 0x7632),
            _byte_perm(x1, y1, 0x5410), _byte_perm(x1, y1, 0x7632)]


def _vadd4(x, y):
    """Per-byte addition modulo 256 of uint32 words."""
    s = (_bytes_of(x).astype(np.uint16) + _bytes_of(y)) & 0xFF
    return s.astype(np.uint8).view("<u4").reshape(-1)


def _s8(words):
    """uint32 words (lanes,) -> (lanes, 4) signed bytes."""
    return _bytes_of(words).reshape(-1, 4).view(np.int8).astype(np.int64)


LANE = np.arange(32)
G, T = LANE >> 2, LANE & 3


def _ld32(smem, addr):
    idx = np.asarray(addr)[:, None] + np.arange(4)
    return np.ascontiguousarray(smem[idx]).view("<u4").reshape(-1)


def _ldmatrix_x4(smem, addr):
    """ldmatrix.m8n8.x4.b16: lane l gives the address of row l % 8 of
    matrix l / 8; register i of lane l holds bytes 4 (l % 4) .. + 3 of row
    l / 4 of matrix i."""
    return [_ld32(smem, addr[8 * i + G] + 4 * T) for i in range(4)]


def _a_matrix(regs):
    """m16n8k32 A fragments (4 registers a lane) -> the (16, 32) s8 A:
    register q of lane (g, t) holds row g + 8 (q % 2), k 16 (q / 2) + 4t."""
    out = np.zeros((16, 32), np.int64)
    for q in range(4):
        rows = (G + 8 * (q % 2))[:, None]
        cols = (16 * (q // 2) + 4 * T)[:, None] + np.arange(4)
        out[rows, cols] = _s8(regs[q])
    return out


def _b_matrix(b0, b1):
    """m16n8k32 B fragments -> the (32, 8) s8 B: register h of lane (g, t)
    holds column g, k 16h + 4t .. + 3."""
    out = np.zeros((32, 8), np.int64)
    for h, regs in enumerate((b0, b1)):
        ks = (16 * h + 4 * T)[:, None] + np.arange(4)
        out[ks, G[:, None]] = _s8(regs)
    return out


def _wrap(x):
    x = np.asarray(x, np.int64) & 0xFFFFFFFF
    return np.where(x >= 2 ** 31, x - 2 ** 32, x)


def _ring_stage(a_bytes, b_bytes, m0, n0, k0, bm, pb, k_major, m, k, n):
    """One ring stage as the kernel's copies lay it out: NP A planes of bm
    rows of RB + 16 bytes, then NP B planes — K-major 128 rows of RB + 16
    bytes, N-major bk rows of 128 pb bytes (int8 16-byte chunk c of row r
    stored at chunk c ^ 2((r / 4) % 4)); zero past M, K and N."""
    bk = RB // pb

    def rows(src, r0, n_rows, count, b0, length):
        out = np.zeros((count, RB + 16), np.uint8)
        for r in range(count):
            if r0 + r < n_rows:
                seg = src[r0 + r, b0:min(b0 + RB, length)]
                out[r, :len(seg)] = seg
        return out.reshape(-1)

    a = [rows(x, m0, m, bm, k0 * pb, k * pb) for x in a_bytes]
    if k_major:
        b = [rows(x, n0, n, BN, k0 * pb, k * pb) for x in b_bytes]
    else:
        b = []
        for x in b_bytes:
            out = np.zeros((bk, BN * pb), np.uint8)
            for r in range(bk):
                if k0 + r < k:
                    seg = x[k0 + r, n0 * pb:min((n0 + BN) * pb, n * pb)]
                    row = np.zeros(BN * pb, np.uint8)
                    row[:len(seg)] = seg
                    if pb == 1:       # swizzle the 16-byte chunks
                        for c in range(BN // 16):
                            d = c ^ (2 * ((r >> 2) & 3))
                            out[r, 16 * d:16 * d + 16] = \
                                row[16 * c:16 * c + 16]
                    else:
                        out[r] = row
            b.append(out.reshape(-1))
    return a, b


def _narrow(a16, b16, bm, k_major):
    """The int16 -> s8 pass: each 16-byte chunk (8 values) through
    __byte_perm(x, y, 0x6420) twice, into rows of RB / 2 + 16 bytes (A,
    K-major B) or the swizzled 128-byte N-major rows."""
    def narrow8(chunk):
        w = chunk.view("<u4")
        return np.concatenate([_bytes_of(_byte_perm(w[0], w[1], 0x6420)),
                               _bytes_of(_byte_perm(w[2], w[3], 0x6420))])

    def rows(src, count):
        out = np.zeros((count, RB // 2 + 16), np.uint8)
        src = src.reshape(count, RB + 16)
        for r in range(count):
            for kc in range(RB // 16):
                out[r, 8 * kc:8 * kc + 8] = narrow8(src[r, 16 * kc:
                                                        16 * kc + 16])
        return out.reshape(-1)

    a8 = [rows(x, bm) for x in a16]
    if k_major:
        b8 = [rows(x, BN) for x in b16]
    else:
        b8 = []
        for x in b16:
            x = x.reshape(RB // 2, 2 * BN)
            out = np.zeros((RB // 2, BN), np.uint8)
            for r in range(RB // 2):
                for cc in range(16):
                    off = (((cc >> 1) ^ (2 * ((r >> 2) & 3))) * 16
                           + (cc & 1) * 8)
                    out[r, off:off + 8] = narrow8(x[r, 16 * cc:16 * cc + 16])
            b8.append(out.reshape(-1))
    return a8, b8


def _mma_stage(layout, a8, b8, bm, pb, k_major, rows_live, acc):
    """mma_stage: every warp's fragments and MMAs on one stage's s8
    planes, by the kernel's addresses; acc[q][wm][mt][wn][j] (16, 8)."""
    bk = RB // pb
    p8 = bk + 16
    warps_m = _warps_m(layout, bm)
    mt_n = bm // 16 // warps_m
    for wm in range(warps_m):
        for wn in range(4):
            a_lane = ((wm * mt_n * 16 + (LANE & 7) + 8 * ((LANE >> 3) & 1))
                      * p8 + 16 * (LANE >> 4))
            for kk in range(0, bk, 32):
                bf = []
                for plane in b8:
                    f = [[None] * 4, [None] * 4]
                    if k_major:
                        row = ((wn * 32 + (LANE & 7) + 8 * (LANE >> 4)) * p8
                               + 16 * ((LANE >> 3) & 1) + kk)
                        for jp in range(2):
                            r = _ldmatrix_x4(plane, row + jp * 16 * p8)
                            f[0][2 * jp], f[1][2 * jp] = r[0], r[1]
                            f[0][2 * jp + 1], f[1][2 * jp + 1] = r[2], r[3]
                    else:
                        col = ((((2 * wn + (G >> 2)) ^ (2 * T)) * 16)
                               + (G & 3) * 4)
                        for h in range(2):
                            w = [_ld32(plane, (kk + 16 * h + 4 * T + i) * BN
                                       + col) for i in range(4)]
                            f[h] = _transpose4x4(w)
                    bf.append(f)
                if layout == "kmm2":        # the pre-adder b1 + b0
                    bf.append([[_vadd4(bf[0][h][j], bf[1][h][j])
                                for j in range(4)] for h in range(2)])
                bmat = [[_b_matrix(f[0][j], f[1][j]) for j in range(4)]
                        for f in bf]
                for mt in range(mt_n):
                    if mt * 16 >= rows_live[wm]:
                        break
                    af = [_ldmatrix_x4(plane, a_lane + mt * 16 * p8 + kk)
                          for plane in a8]
                    if layout == "kmm2":    # the pre-adder a1 + a0
                        af.append([_vadd4(af[0][r], af[1][r])
                                   for r in range(4)])
                    amat = [_a_matrix(regs) for regs in af]
                    # (accumulator, A operand, B operand): plane 0 high,
                    # 1 low, 2 the pre-adder
                    prods = {"mm1": [(0, 0, 0)],
                             "kmm2": [(0, 0, 0), (1, 2, 2), (2, 1, 1)],
                             "kmm2_split": [(0, 0, 0), (1, 0, 1), (1, 1, 0),
                                            (2, 1, 1)],
                             "mm2": [(0, 0, 0), (1, 0, 1), (2, 1, 0),
                                     (3, 1, 1)]}[layout]
                    for j in range(4):
                        for q, qa, qb in prods:
                            acc[q][wm][mt][wn][j] += amat[qa] @ bmat[qb][j]


def _warps_m(layout, bm):
    """Warp rows of a tile: one at 16 rows and for mm1; at 64 rows the
    KMM2 layouts two (32-row spans), mm2 four (16-row spans)."""
    if layout == "mm1" or bm < 32:
        return 1
    return bm // 16 if layout == "mm2" else bm // 32


def emulate_launch(layout, a_planes, b_planes, h, combine_int32, k_major,
                   split=None):
    """One launch of staged_pipe.cu in numpy on (M, K) A and (K, N) B
    planes (int8 or int16 numpy arrays; B given as its (K, N) values and
    laid out K-major or N-major by ``k_major``).  Returns the (M, N) int32
    or float32 output."""
    pb = a_planes[0].dtype.itemsize
    m, k = a_planes[0].shape
    n = b_planes[0].shape[1]
    plan = mm1_plan.plan_staged(layout, m, k, n, H100_SMS, pb, split)
    bm, bk = plan.bm, RB // pb
    nacc = mm1_plan.STAGED_ACCS[layout]
    warps_m = _warps_m(layout, bm)
    mt_n = bm // 16 // warps_m
    a_bytes = [np.ascontiguousarray(x).view(np.uint8).reshape(m, k * pb)
               for x in a_planes]
    if k_major:
        b_bytes = [np.ascontiguousarray(x.T).view(np.uint8)
                   .reshape(n, k * pb) for x in b_planes]
    else:
        b_bytes = [np.ascontiguousarray(x).view(np.uint8).reshape(k, n * pb)
                   for x in b_planes]
    out = np.zeros((m, n), np.int32 if combine_int32 or layout == "mm1"
                   else np.float32)
    for tm in range(plan.tiles_m):
        for tn in range(plan.tiles_n):
            m0, n0 = tm * bm, tn * BN
            rows_live = [m - (m0 + wm * mt_n * 16) for wm in range(warps_m)]
            total = np.zeros((nacc, warps_m, mt_n, 4, 4, 16, 8), np.int64)
            for kb, ke in plan.k_ranges():
                acc = np.zeros_like(total)
                for k0 in range(kb, ke, bk):
                    a_st, b_st = _ring_stage(a_bytes, b_bytes, m0, n0, k0,
                                             bm, pb, k_major, m, k, n)
                    if pb == 2:
                        a_st, b_st = _narrow(a_st, b_st, bm, k_major)
                    _mma_stage(layout, a_st, b_st, bm, pb, k_major,
                               rows_live, acc)
                total = _wrap(total + _wrap(acc))   # the last block's sum
            for wm in range(warps_m):
                for mt in range(mt_n):
                    for wn in range(4):
                        for j in range(4):
                            for rr in range(16):
                                for c in range(8):
                                    mm = m0 + (wm * mt_n + mt) * 16 + rr
                                    nn = n0 + wn * 32 + (8 * j + c if k_major
                                                         else 4 * c + j)
                                    if mm >= m or nn >= n:
                                        continue
                                    cv = total[:, wm, mt, wn, j, rr, c]
                                    out[mm, nn] = _epilogue(
                                        layout, cv, h, combine_int32)
    return out


def _epilogue(layout, c, h, combine_int32):
    """store_out: the split route's Cs rebuild, then the int32-ring or fp32
    combine, one rounded operation at a time (mm2: C10 and C01 converted
    apart, then added in fp32)."""
    if layout == "mm1":
        return c[0]
    f = np.float32
    if layout == "mm2":
        u1, u10, u01, u0 = (int(v) & 0xFFFFFFFF for v in c)
        if combine_int32:
            return _wrap((u1 << (2 * h)) + ((u10 + u01) << h) + u0)
        c1f, c10f, c01f, c0f = (f(_wrap(v)) for v in (u1, u10, u01, u0))
        mid = f(c10f + c01f)
        return f(f(f(c1f * f(2.0 ** (2 * h))) + f(mid * f(2.0 ** h)))
                 + c0f)
    u1, us, u0 = (int(v) & 0xFFFFFFFF for v in c)
    if layout == "kmm2_split":
        us = (us + u1 + u0) & 0xFFFFFFFF
    if combine_int32:
        return _wrap((u1 << (2 * h)) + ((us - u1 - u0) << h) + u0)
    c1f, csf, c0f = (f(_wrap(v)) for v in (u1, us, u0))
    mid = f(f(csf - c1f) - c0f)
    return f(f(f(c1f * f(2.0 ** (2 * h))) + f(mid * f(2.0 ** h))) + c0f)


def _ref(layout, planes, h, ci):
    tp = [torch.from_numpy(p) for p in planes]
    if layout == "mm1":
        return ref_int_gemm(*tp).numpy()
    if layout == "mm2":
        return ref_mm2_planes(*tp, h, combine_int32=ci).numpy()
    return ref_kmm2_planes(*tp, h, combine_int32=ci).numpy()


def _edge_planes(layout, m, k, n, rng):
    """Planes at the layout's extremes: mm1 int8 codes with +-127 and -128;
    kmm2 int8 planes at h = 7 (pre-adder sums down to -128); int16 branch
    planes at h2 = 6 (s8 route) and 7 (split route, leaves up to 127); mm2
    int8 planes at h = 8 (w = 16: digits -128 .. 127)."""
    if layout == "mm1":
        a = rng.integers(-128, 128, (m, k)).astype(np.int8)
        b = rng.integers(-128, 128, (k, n)).astype(np.int8)
        a[0, :] = -128
        b[:, 0] = -128
        return [a, b], 0
    if layout == "kmm2_i8":
        planes, h = _int8_planes(14, (m, k), (k, n), rng)
        planes[0][0], planes[1][0] = -64, -64          # a1 + a0 = -128
        planes[2][:, 0], planes[3][:, 0] = -64, -64
        return planes, h
    if layout == "mm2":
        planes, h = _int8_planes(16, (m, k), (k, n), rng)
        planes[0][0], planes[1][0] = -128, -128
        planes[2][:, 0], planes[3][:, 0] = -128, 127
        return planes, h
    return _branch_planes(6 if layout == "kmm2_i16" else 7, (m, k), (k, n),
                          rng)


EMULATED = [("mm1", (5, 150, 130), None), ("mm1", (70, 100, 40), 2),
            ("kmm2_i8", (5, 150, 130), None), ("kmm2_i8", (70, 100, 140), 2),
            ("kmm2_i16", (3, 70, 140), 2), ("kmm2_i16", (66, 40, 140), None),
            ("split", (3, 70, 140), 2), ("split", (66, 40, 140), None),
            ("mm2", (5, 150, 130), None), ("mm2", (70, 100, 140), 2),
            ("mm2", (3, 300, 200), 3)]


@pytest.mark.parametrize("kind,mkn,split", EMULATED)
@pytest.mark.parametrize("k_major", [True, False])
def test_emulated_launch_equals_the_plain_version(kind, mkn, split, k_major):
    """The kernel's data path, emulated, at the 16-row tile (ragged K, N
    past one column tile) and the 64-row tile (a second tile whose row
    blocks past M are skipped), with split-K forced where ``split`` is
    given: equal to ref_int_gemm / ref_kmm2_planes in every combine."""
    m, k, n = mkn
    rng = np.random.default_rng(m * k + n)
    planes, h = _edge_planes(kind, m, k, n, rng)
    layout = {"mm1": "mm1", "kmm2_i8": "kmm2", "kmm2_i16": "kmm2",
              "split": "kmm2_split", "mm2": "mm2"}[kind]
    assert mm1_plan.staged_tile_rows(layout, m, n) == (16 if m < 64 else 64)
    if split is not None:
        assert mm1_plan.plan_staged(layout, m, k, n, H100_SMS,
                                    planes[0].dtype.itemsize,
                                    split).split == split
    for ci in ((True,) if kind == "mm1" else (False, True)):
        got = emulate_launch(layout, planes[:len(planes) // 2],
                             planes[len(planes) // 2:], h, ci, k_major,
                             split)
        np.testing.assert_array_equal(got, _ref(layout, planes, h, ci),
                                      err_msg=f"{kind} {mkn} {ci}")


def test_emulated_split_k_sum_then_combine_at_full_magnitude():
    """Every digit at its extreme over K = 1024: the int32 combine wraps
    (C1 << 14 leaves 32 bits), and split 4 ways or not, both combines of
    the summed partials equal the plain version."""
    m, k, n = 1, 1024, 8
    planes = [np.full((m, k), 63, np.int8), np.full((m, k), -64, np.int8),
              np.full((k, n), 63, np.int8), np.full((k, n), 63, np.int8)]
    planes[3][:, ::2] = -64
    for split in (4, 1):
        for ci in (False, True):
            got = emulate_launch("kmm2", planes[:2], planes[2:], 7, ci,
                                 True, split)
            np.testing.assert_array_equal(got, _ref("kmm2", planes, 7, ci))
