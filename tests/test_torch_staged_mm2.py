"""The staged MM2 digit-plane kernel (``mm2_gemm.mm2_gemm_planes``, layout
mm2 of ``csrc/staged_pipe.cu``) on the CPU: what its wrapper takes, the B
layout ``ops`` hands it, its split-K plan and its split-K epilogue.

  * ``mm2_gemm_planes`` on B planes row-major and K-major (``t.t()`` of a
    contiguous (N, K) tensor) equals JAX's ``mm2_gemm_planes`` in
    interpret mode and ``ref_mm2_planes`` at every split point h 1-8, both
    combines, at hostile M, K, N;
  * ``ops.run_plan`` on an MM2 plan with a K-major B equals JAX's
    ``run_plan``, and B reaches the digit split uncopied: the planes the
    kernel wrapper receives are K-major, split from B's own storage;
  * ``mm1_plan.plan_staged("mm2", ...)`` splits K in whole stages and cuts
    the split to one wave;
  * a numpy emulation of the kernel's split-K epilogue — per-split int32
    partials of the four accumulators, summed modulo 2^32 in any arrival
    order, then the combine with C10 and C01 converted apart — equals
    ``ref_mm2_planes`` at a K where the partials wrap.

The kernel's fragment and ring data path is emulated in
``tests/test_torch_staged_pipe.py`` (layout mm2 among the others); the
CUDA kernel itself is held to the plain version on the card by
``chip_smoke.py``.
"""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.dispatch import ExecPlan as JaxPlan  # noqa: E402
from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels.mm2_gemm import mm2_gemm_planes as jax_mm2  # noqa: E402
from repro_torch.core.dispatch import ExecPlan  # noqa: E402
from repro_torch.kernels import mm1_plan, mm2_gemm, ops  # noqa: E402
from repro_torch.kernels.ref import ref_mm2_planes, split_planes  # noqa: E402

H100_SMS = 132
HOSTILE = [(5, 150, 13), (1, 70, 1), (33, 40, 17), (17, 256, 130)]


def _rand(w, shape, rng):
    lim = 2 ** (w - 1)
    return rng.integers(-lim, lim, size=shape).astype(np.int32)


def _k_major(x: np.ndarray) -> torch.Tensor:
    """The (K, N) values as ``t.t()`` of a contiguous (N, K) tensor."""
    t = torch.from_numpy(np.ascontiguousarray(x.T)).t()
    assert t.t().is_contiguous()
    return t


def _planes(w, shape_a, shape_b, rng):
    """Centered int8 digit planes at h = ceil(w/2), with the extreme codes
    -2^(w-1) and 2^(w-1) - 1 in the first row of A and column of B."""
    a, b = _rand(w, shape_a, rng), _rand(w, shape_b, rng)
    a[0, ::2], a[0, 1::2] = -2 ** (w - 1), 2 ** (w - 1) - 1
    b[::2, 0], b[1::2, 0] = 2 ** (w - 1) - 1, -2 ** (w - 1)
    h = -(-w // 2)
    a1, a0, _ = split_planes(torch.from_numpy(a), h)
    b1, b0, _ = split_planes(torch.from_numpy(b), h)
    return [t.numpy() for t in (a1, a0, b1, b0)], h


@pytest.mark.parametrize("mkn", HOSTILE)
@pytest.mark.parametrize("h", range(1, mm2_gemm.MAX_H + 1))
def test_mm2_planes_either_b_layout_match_jax(mkn, h):
    """w = 2h: every split point up to the kernel's h = 8 (w = 16)."""
    m, k, n = mkn
    rng = np.random.default_rng(10 * h + k)
    planes, hh = _planes(2 * h, (m, k), (k, n), rng)
    assert hh == h
    jp = [jnp.asarray(p) for p in planes]
    a_planes = [torch.from_numpy(p) for p in planes[:2]]
    layouts = ([torch.from_numpy(p) for p in planes[2:]],
               [_k_major(p) for p in planes[2:]])
    mm2_gemm.reset_launches()
    for ci in (False, True):
        ref = np.asarray(jax_mm2(*jp, h=h, block_m=m, block_n=n, block_k=k,
                                 combine_int32=ci, interpret=True))
        plain = ref_mm2_planes(*map(torch.from_numpy, planes), h,
                               combine_int32=ci).numpy()
        np.testing.assert_array_equal(plain, ref)
        for b_planes in layouts:
            got = mm2_gemm.mm2_gemm_planes(*a_planes, *b_planes, h=h,
                                           combine_int32=ci)
            assert str(ref.dtype) == str(got.dtype).replace("torch.", "")
            np.testing.assert_array_equal(
                got.numpy(), ref,
                err_msg=f"h={h} int32={ci} B {b_planes[0].stride()}")
    assert mm2_gemm.launches["mm2_gemm_planes"] == 0      # CPU: plain


def test_mm2_planes_refuse_mixed_or_strided_b():
    a = torch.zeros((4, 8), dtype=torch.int8)
    b = torch.zeros((8, 6), dtype=torch.int8)
    bk = torch.zeros((6, 8), dtype=torch.int8).t()
    with pytest.raises(ValueError, match="contiguous or K-major"):
        mm2_gemm.mm2_gemm_planes(a, a, b, bk, h=4)
    with pytest.raises(ValueError, match="contiguous or K-major"):
        mm2_gemm.mm2_gemm_planes(a, a, *(torch.zeros((8, 12),
                                                     dtype=torch.int8)[:, ::2]
                                         for _ in range(2)), h=4)
    for h in (0, mm2_gemm.MAX_H + 1):
        with pytest.raises(ValueError, match="fit s8"):
            mm2_gemm.mm2_gemm_planes(a, a, bk, bk, h=h)


def _jax_plan(plan: ExecPlan) -> JaxPlan:
    return JaxPlan(plan.variant, plan.w, plan.m, backend="pallas",
                   block_m=8, block_n=16, block_k=plan.block_k,
                   combine_int32=plan.combine_int32, depth=plan.depth)


class _Spy:
    """Records the tensors a function is handed, then runs it."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __call__(self, *args, **kw):
        self.calls.append([t for t in args if isinstance(t, torch.Tensor)])
        return self.fn(*args, **kw)


@pytest.mark.parametrize("w,ci", [(9, False), (12, False), (15, False),
                                  (16, False), (9, True), (12, True)])
def test_run_plan_mm2_k_major_b_uncopied_matches_jax(monkeypatch, w, ci):
    """The tied lm_head's case: B arrives as the K-major view ``embed.T``
    in its int16 carrier with K a multiple of block_k.  ``ops`` splits B's
    own storage (no copy) into K-major planes, which the kernel wrapper
    receives as they are, and the result equals JAX's ``run_plan``."""
    spy_split = _Spy(ops._planes)
    spy_mm2 = _Spy(ops.mm2_gemm_planes)
    monkeypatch.setattr(ops, "_planes", spy_split)
    monkeypatch.setattr(ops, "mm2_gemm_planes", spy_mm2)
    rng = np.random.default_rng(w)
    m, k, n = 5, 128, 40
    a, embed = _rand(w, (m, k), rng), _rand(w, (n, k), rng)
    b = torch.from_numpy(embed).to(torch.int16).t()      # embed.T, K-major
    plan = ExecPlan("mm2", w, block_k=64, combine_int32=ci)
    got = ops.run_plan(torch.from_numpy(a), b, plan=plan)
    ref = np.asarray(jax_ops.run_plan_jit(
        jnp.asarray(a), jnp.asarray(embed.T), _jax_plan(plan),
        interpret=True))
    np.testing.assert_array_equal(got.numpy(), ref)
    split_b = spy_split.calls[1][0]
    assert split_b.data_ptr() == b.data_ptr() and split_b.stride() == \
        b.stride()
    (planes,) = spy_mm2.calls
    assert all(t.is_contiguous() for t in planes[:2])
    assert all(t.t().is_contiguous() and not t.is_contiguous()
               and t.shape == (k, n) for t in planes[2:])


@pytest.mark.parametrize("m,k,n", [(4, 2048, 8192), (64, 2048, 8192),
                                   (4, 2048, 128512), (2048, 2048, 8192),
                                   (4, 8192, 2048), (17, 300, 200),
                                   (1, 70, 1), (64, 1536, 40)])
def test_mm2_plan_splits_k_in_whole_stages_within_one_wave(m, k, n):
    p = mm1_plan.plan_staged("mm2", m, k, n, H100_SMS, 1)
    bk = mm1_plan.STAGED_ROW_BYTES
    assert p.bm == (64 if m > 16 and n > mm1_plan.BN else 16)
    ranges = p.k_ranges()
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    assert all(e0 == s1 for (_, e0), (s1, _) in zip(ranges, ranges[1:]))
    assert all(e > s for s, e in ranges)
    if p.split > 1:
        assert p.k_split % bk == 0 and p.tiles < H100_SMS
        assert p.blocks <= H100_SMS * mm1_plan.STAGED_BLOCKS_PER_SM[
            ("mm2", p.bm)]
        assert p.ws_ints == p.tiles * p.split * 4 * p.bm * mm1_plan.BN
    else:
        assert p.ws_ints == 0
    # llama's wi at decode: 64 tiles, two 16-row blocks an SM: 4 splits
    if (m, k, n) == (4, 2048, 8192):
        assert (p.bm, p.split, p.k_split) == (16, 4, 512)
    if (m, k, n) == (64, 2048, 8192):
        assert (p.bm, p.tiles, p.split) == (64, 64, 2)
    if n >= 128512 or m >= 2048:
        assert p.split == 1


def _wrap(x):
    x = np.asarray(x, np.int64) & 0xFFFFFFFF
    return np.where(x >= 2 ** 31, x - 2 ** 32, x).astype(np.int64)


def _epilogue(parts, h, combine_int32, order):
    """The last block's sum of the splits' int32 partials (modulo 2^32, in
    ``order``), then store_out's MM2 combine."""
    acc = np.zeros_like(parts[0])
    for s in order:
        acc = _wrap((acc & 0xFFFFFFFF) + (parts[s] & 0xFFFFFFFF))
    c1, c10, c01, c0 = acc
    if combine_int32:
        u = [x & 0xFFFFFFFF for x in (c1, c10, c01, c0)]
        return _wrap((u[0] << (2 * h)) + ((u[1] + u[2]) << h)
                     + u[3]).astype(np.int32)
    f = np.float32
    c1f, c10f, c01f, c0f = (x.astype(f) for x in (c1, c10, c01, c0))
    mid = (c10f + c01f).astype(f)
    return (((c1f * f(2.0 ** (2 * h))).astype(f)
             + (mid * f(2.0 ** h)).astype(f)).astype(f) + c0f).astype(f)


def test_emulated_split_k_epilogue_wraps_like_the_plain_version():
    """K = 2^18 + 64 with every digit product at 2^14 in some columns: the
    int32 accumulators wrap, per split and in the sum.  Four splits of the
    plan's kind (whole stages, the last ragged) summed in every arrival
    order give one result, equal to ref_mm2_planes in both combines.  At
    element (2, 2), C10 = 2^24 + 1 and C01 = 1: converted apart they add
    to 2^24 in fp32, converted after an int32 add to 2^24 + 2 — the
    kernel must keep them apart to the combine."""
    m, k, n, h = 3, 2 ** 18 + 64, 6, 8
    rng = np.random.default_rng(0)
    planes = [rng.integers(-128, 128, size=s).astype(np.int8)
              for s in ((m, k), (m, k), (k, n), (k, n))]
    planes[0][0], planes[1][0] = -128, -128
    planes[2][:, 0], planes[3][:, 0] = -128, -128
    planes[2][:, 1], planes[3][:, 1] = -128, 127
    planes[1][1] = 127
    planes[0][2], planes[1][2] = 1, 0             # a1 = 1, a0 = 0 ...
    planes[1][2, 7] = 1                           # ... but one 1
    planes[2][:, 2], planes[3][:, 2] = 0, 0
    planes[3][:2 ** 18, 2], planes[3][2 ** 18, 2] = 64, 1   # C10 2^24 + 1
    planes[2][7, 2] = 1                           # C01 = 1
    a1, a0, b1, b0 = (p.astype(np.int64) for p in planes)
    bk = mm1_plan.STAGED_ROW_BYTES
    per = -(-(k // bk) // 4) * bk
    bounds = [(s * per, min(k, (s + 1) * per)) for s in range(4)]
    assert bounds[-1][1] == k and bounds[-1][1] - bounds[-1][0] < per
    parts = np.stack([_wrap(np.stack([x[:, s:e] @ y[s:e] for x, y in
                                      ((a1, b1), (a1, b0), (a0, b1),
                                       (a0, b0))]))
                      for s, e in bounds])
    full = np.stack([x @ y for x, y in ((a1, b1), (a1, b0), (a0, b1),
                                        (a0, b0))])
    assert (np.abs(full) >= 2 ** 31).any()             # the sums wrap
    tp = [torch.from_numpy(p) for p in planes]
    for ci in (False, True):
        want = ref_mm2_planes(*tp, h, combine_int32=ci).numpy()
        outs = [_epilogue(parts, h, ci, order)
                for order in itertools.permutations(range(4))]
        for got in outs:
            np.testing.assert_array_equal(got, want)
    c = _wrap(full)
    assert (c[1][2, 2], c[2][2, 2]) == (2 ** 24 + 1, 1)
    f = np.float32
    fused_mid = _wrap(c[1] + c[2]).astype(f)
    apart_mid = (c[1].astype(f) + c[2].astype(f)).astype(f)
    assert (fused_mid[2, 2], apart_mid[2, 2]) == (2 ** 24 + 2, 2 ** 24)
