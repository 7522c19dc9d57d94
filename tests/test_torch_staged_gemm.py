"""The port's staged kernels (``mm1_gemm``, ``kmm2_gemm_planes``,
``mm2_gemm_planes``) and its execution seam (``kernels.ops``: ``int_gemm``,
``run_plan``, the staged path and ``_kmm4_core``) against the JAX package,
whose Pallas kernels run in interpret mode.

On CPU tensors every wrapper runs its kernel's plain version
(``kernels/ref.py``); those, and ``run_plan`` for every ported variant at
w in {4, 8, 9, 12, 14, 15, 16, 17, 20, 22, 23, 24, 26}, must equal the
reference bit for bit (``array_equal``): hostile shapes with K not a
multiple of ``block_k``, both combines, ``use_ref_kernels`` on and off,
the int32 row-sum wrap at w=24 and the +-2^25 codes at w=26.  Inside the
port staged == fused == mirror in every numerics class, as the reference's
``tests/test_fused_gemm.py`` holds its own.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.dispatch import ExecPlan as JaxPlan  # noqa: E402
from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels.kmm_gemm import kmm2_gemm_planes as jax_kmm2  # noqa: E402
from repro.kernels.mm1_gemm import mm1_gemm as jax_mm1  # noqa: E402
from repro.kernels.mm2_gemm import mm2_gemm_planes as jax_mm2  # noqa: E402
from repro.kernels.ref import ref_digit_planes as jax_planes  # noqa: E402
from repro_torch.core.dispatch import ExecPlan  # noqa: E402
from repro_torch.core.kmm import max_exact_k  # noqa: E402
from repro_torch.kernels import fused_gemm as fg  # noqa: E402
from repro_torch.kernels import kmm_gemm, mm1_gemm, mm2_gemm, ops  # noqa: E402
from repro_torch.kernels.ref import (ref_digit_planes,  # noqa: E402
                                     ref_int_gemm_i64)
from repro_torch.tune import space  # noqa: E402

WIDTHS = [4, 8, 9, 12, 14, 15, 16, 17, 20, 22, 23, 24, 26]
# K not a multiple of 32 or 64; one row; one column.
HOSTILE = [(5, 150, 13), (1, 70, 1), (33, 40, 17)]
MODULES = (mm1_gemm, kmm_gemm, mm2_gemm)


def _no_launches():
    return ({**mm1_gemm.launches, **kmm_gemm.launches, **mm2_gemm.launches}
            == {k: 0 for m in MODULES for k in m.launches}
            and fg.launches == {m: 0 for m in fg.MODES})


def _rand(w, shape, rng):
    lim = 2 ** (w - 1)
    return rng.integers(-lim, lim, size=shape).astype(np.int32)


def _jax_plan(plan: ExecPlan) -> JaxPlan:
    """The reference's plan for a port plan: M/N tiles of 8 and 16 (they
    never change a value; small ones keep the interpret-mode grid short)."""
    return JaxPlan(plan.variant, plan.w, plan.m, backend="pallas",
                   block_m=8, block_n=16, block_k=plan.block_k,
                   combine_int32=plan.combine_int32, depth=plan.depth)


def _both(a, b, plan, use_ref_kernels):
    ref = np.asarray(jax_ops.run_plan_jit(
        jnp.asarray(a), jnp.asarray(b), _jax_plan(plan), interpret=True,
        use_ref_kernels=use_ref_kernels))
    got = ops.run_plan(torch.from_numpy(a), torch.from_numpy(b), plan=plan,
                       use_ref_kernels=use_ref_kernels)
    assert str(ref.dtype) == str(got.dtype).replace("torch.", "")
    return ref, got.numpy()


@pytest.mark.parametrize("w", [4, 8])
def test_mm1_gemm_matches_jax(w):
    rng = np.random.default_rng(w)
    a = _rand(w, (16, 96), rng).astype(np.int8)
    b = _rand(w, (96, 40), rng).astype(np.int8)
    ref = np.asarray(jax_mm1(jnp.asarray(a), jnp.asarray(b), block_m=16,
                             block_n=40, block_k=96, interpret=True))
    got = mm1_gemm.mm1_gemm(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                  ref_int_gemm_i64(a, b))


@pytest.mark.parametrize("w", [9, 12, 14, 15, 16])
def test_plane_kernels_match_jax(w):
    """kmm2 (w <= 14) and mm2 (every w here) on the centered int8 planes,
    both combines; the planes themselves equal the reference's."""
    rng = np.random.default_rng(w)
    a, b = _rand(w, (16, 96), rng), _rand(w, (96, 40), rng)
    ja1, ja0, h, _ = jax_planes(jnp.asarray(a), w)
    jb1, jb0, _, _ = jax_planes(jnp.asarray(b), w)
    ta1, ta0, th, _ = ref_digit_planes(torch.from_numpy(a), w)
    tb1, tb0, _, _ = ref_digit_planes(torch.from_numpy(b), w)
    assert th == h
    for j, t in ((ja1, ta1), (ja0, ta0), (jb1, tb1), (jb0, tb0)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    kernels = [(jax_mm2, mm2_gemm.mm2_gemm_planes)]
    if w <= 14:
        kernels.append((jax_kmm2, kmm_gemm.kmm2_gemm_planes))
    for jfn, tfn in kernels:
        for ci in (False, True):
            ref = np.asarray(jfn(ja1, ja0, jb1, jb0, h=h, block_m=16,
                                 block_n=40, block_k=96, combine_int32=ci,
                                 interpret=True))
            got = tfn(ta1, ta0, tb1, tb0, h=h, combine_int32=ci)
            assert str(ref.dtype) == str(got.dtype).replace("torch.", "")
            np.testing.assert_array_equal(got.numpy(), ref,
                                          err_msg=f"{tfn.__name__} {ci}")
    assert _no_launches()


@pytest.mark.parametrize("w", [17, 22, 23, 26])
def test_kmm2_planes_int16_matches_jax(w):
    """The int16 branch planes of ``_kmm4_core`` (both kernel routes: s8
    pre-adders through w=22, split from w=23) on the plain version."""
    rng = np.random.default_rng(w)
    a, b = _rand(w, (8, 64), rng), _rand(w, (64, 24), rng)
    h = -(-w // 2)
    h2 = -(-(h + 1) // 2)
    mask = (1 << h) - 1
    av = (a >> h) + ((a & mask) - (1 << (h - 1)))      # the A1 + A0 branch
    bv = (b >> h) + ((b & mask) - (1 << (h - 1)))
    planes = [(av >> h2).astype(np.int16), (av & ((1 << h2) - 1)).astype(
        np.int16), (bv >> h2).astype(np.int16),
        (bv & ((1 << h2) - 1)).astype(np.int16)]
    assert kmm_gemm.route(torch.int16, h2) == ("split" if w >= 23 else "s8")
    for ci in (False, True):
        ref = np.asarray(jax_kmm2(*map(jnp.asarray, planes), h=h2,
                                  block_m=8, block_n=24, block_k=64,
                                  combine_int32=ci, interpret=True))
        got = kmm_gemm.kmm2_gemm_planes(*map(torch.from_numpy, planes),
                                        h=h2, combine_int32=ci)
        np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("w", WIDTHS)
def test_run_plan_matches_jax_for_every_ported_variant(w):
    """Every candidate of the port's space at a hostile shape (K=150 is
    no multiple of block_k 64), kernels and mirror, against the
    reference's ``run_plan``; plus each staged variant in the int32 ring
    outside its exactness bound, where the space leaves it out."""
    rng = np.random.default_rng(w)
    shape = HOSTILE[0]
    a, b = _rand(w, shape[:2], rng), _rand(w, shape[1:], rng)
    cands = space.pruned_space(shape, w, tile_choices=(64,))
    assert cands
    # (the reference itself overflows computing z*z*kp in int32 at w=26)
    z, kp = 1 << (-(-w // 2) - 1), 192
    windows = {("kmm2", 1): 2 <= w <= 14,
               ("kmm2", 2): 4 <= w <= 26 and z * z * kp < 2 ** 31,
               ("mm2", 1): 2 <= w <= 16}
    extra = [ExecPlan(v, w, block_k=64, combine_int32=True, depth=d)
             for (v, d), ok in windows.items() if ok]
    for plan in cands + extra:
        for use_ref in (False, True):
            ref, got = _both(a, b, plan, use_ref)
            np.testing.assert_array_equal(
                got, ref, err_msg=f"{plan} use_ref_kernels={use_ref}")
    assert _no_launches()


@pytest.mark.parametrize("mkn", HOSTILE[1:])
def test_run_plan_hostile_shapes(mkn):
    rng = np.random.default_rng(mkn[0])
    for w, plan in ((8, ExecPlan("mm1", 8, block_k=32, combine_int32=True,
                                 depth=0)),
                    (12, ExecPlan("kmm2", 12, block_k=64)),
                    (16, ExecPlan("mm2", 16, block_k=32)),
                    (24, ExecPlan("kmm2", 24, block_k=64, depth=2))):
        a, b = _rand(w, mkn[:2], rng), _rand(w, mkn[1:], rng)
        ref, got = _both(a, b, plan, False)
        np.testing.assert_array_equal(got, ref, err_msg=str(plan))


def test_wrapping_rows_and_top_codes_match_jax():
    """At w=24 rows of +-2^22 over K=1024 wrap the int32 row sums, as in
    the reference; at w=26 the quantizer's +-2^25 codes split as any
    other.  Staged depth 2 and fused kmm4 agree with JAX and each other,
    in fp32 and (where the reference can form z*z*kp in int32) in the
    int32 ring."""
    rng = np.random.default_rng(0)
    a, b = _rand(24, (4, 1024), rng), _rand(24, (1024, 16), rng)
    a[0], a[1] = 2 ** 22, -2 ** 22
    c, d = _rand(26, (6, 96), rng), _rand(26, (96, 8), rng)
    top = 2 ** 25
    c[0], c[1], c[2, ::2] = top, -top, top
    d[:, 0], d[:, 1], d[::3, 2] = top, -top, top
    for (x, y), w, bk, combines in (((a, b), 24, 256, (False,)),
                                    ((c, d), 26, 32, (False, True))):
        for ci in combines:
            outs = []
            for variant in ("kmm2", "fused"):
                plan = ExecPlan(variant, w, block_k=bk, combine_int32=ci,
                                depth=2)
                ref, got = _both(x, y, plan, False)
                np.testing.assert_array_equal(got, ref, err_msg=str(plan))
                outs.append(got)
            np.testing.assert_array_equal(outs[0], outs[1])
    got = ops.run_plan(torch.from_numpy(a), torch.from_numpy(b),
                       plan=ExecPlan("kmm2", 24, block_k=256,
                                     depth=2)).numpy()
    exact = ref_int_gemm_i64(a, b).astype(np.float64)
    rel = np.abs(got - exact).max(1) / np.abs(exact).max(1)
    assert rel[0] > 1e-4 and rel[2] < 1e-5      # a wrapped row, a random one


def _tiles_plans(w, bk):
    """(fused, staged) plans of one numerics class at ``w``."""
    if w <= 8:
        return [(ExecPlan("fused", w, block_k=bk, combine_int32=True,
                          depth=0),
                 ExecPlan("mm1", w, block_k=bk, combine_int32=True,
                          depth=0))]
    out = []
    if w <= 14:
        out += [(ExecPlan("fused", w, block_k=bk, combine_int32=ci),
                 ExecPlan("kmm2", w, block_k=bk, combine_int32=ci))
                for ci in (False, True)]
    if w <= 16:
        out.append((ExecPlan("fused_mm2", w, block_k=bk),
                     ExecPlan("mm2", w, block_k=bk)))
    out.append((ExecPlan("fused", w, block_k=bk, depth=2),
                ExecPlan("kmm2", w, block_k=bk, depth=2)))
    return out


@pytest.mark.parametrize("w", [4, 8, 12, 14, 15, 16, 20])
def test_staged_equals_fused_equals_mirror(w):
    """Same ``block_k``: the fused kernel reproduces the staged path and
    the mirror bit for bit, fp32 combines included — depth 2 forced below
    its analytic window too (w=12, 15) — and exact plans equal the int64
    oracle."""
    rng = np.random.default_rng(w)
    for mkn in [(33, 70, 17), (1, 64, 1), (130, 70, 50)]:
        a = torch.from_numpy(_rand(w, mkn[:2], rng))
        b = torch.from_numpy(_rand(w, mkn[1:], rng))
        oracle = ref_int_gemm_i64(a.numpy(), b.numpy())
        for bk in (32, 256):
            for fused, staged in _tiles_plans(w, bk):
                out = ops.run_plan(a, b, plan=fused)
                for other in (ops.run_plan(a, b, plan=staged),
                              ops.run_plan(a, b, plan=fused,
                                           use_ref_kernels=True)):
                    np.testing.assert_array_equal(out.numpy(),
                                                  other.numpy(),
                                                  err_msg=f"{fused} {mkn}")
                if fused.is_exact_int and max_exact_k(w) >= mkn[1]:
                    np.testing.assert_array_equal(
                        out.numpy().astype(np.int64), oracle)


@pytest.mark.parametrize("w", [8, 12, 16, 20])
def test_int_gemm_matches_jax(w):
    """The default plan (the fused kernel, block_k 256) against the
    reference's ``int_gemm`` on the Pallas backend; ``exact=True`` within
    ``max_exact_k``."""
    rng = np.random.default_rng(w)
    a, b = _rand(w, (9, 100), rng), _rand(w, (100, 20), rng)
    ref = np.asarray(jax_ops.int_gemm(jnp.asarray(a), jnp.asarray(b), w=w,
                                      backend="pallas", block_m=16,
                                      block_n=32, interpret=True))
    got = ops.int_gemm(torch.from_numpy(a), torch.from_numpy(b), w=w)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)
    if max_exact_k(w) >= 100:
        got = ops.int_gemm(torch.from_numpy(a), torch.from_numpy(b), w=w,
                           exact=True)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                      ref_int_gemm_i64(a, b))


def test_run_plan_takes_strided_operands():
    """The tied lm_head hands the seam a transposed weight view: every
    route gives what it gives on contiguous operands (the kernels take
    contiguous planes only, on both devices)."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(_rand(12, (5, 96), rng))
    bt = torch.from_numpy(_rand(12, (40, 96), rng)).t()      # (96, 40) view
    assert not bt.is_contiguous()
    for plan in (ExecPlan("kmm2", 12, block_k=64),
                 ExecPlan("mm2", 12, block_k=64),
                 ExecPlan("kmm2", 12, block_k=64, depth=2),
                 ExecPlan("fused", 12, block_k=64),
                 ExecPlan("mm1", 8, block_k=64, combine_int32=True,
                          depth=0)):
        np.testing.assert_array_equal(
            ops.run_plan(a, bt, plan=plan).numpy(),
            ops.run_plan(a, bt.contiguous(), plan=plan).numpy())
    with pytest.raises(ValueError, match="contiguous"):
        mm2_gemm.mm2_gemm_planes(*(torch.zeros((8, 4), dtype=torch.int8).t()
                                   for _ in range(2)),
                                 *(torch.zeros((8, 3), dtype=torch.int8)
                                   for _ in range(2)), h=4)


def test_int_gemm_exact_refuses_overflow_and_runs_the_aten_variants():
    """Exact output past max_exact_k and an unknown backend still raise, and
    so does depth 3 on "cuda", as the reference's Pallas backend does
    (its message names "aten"); the ATen route and the variants that were
    refused before run and equal JAX and the int64 oracle."""
    rng = np.random.default_rng(8)
    a = torch.from_numpy(_rand(8, (8, 4096), rng))
    b = torch.from_numpy(_rand(8, (4096, 8), rng))
    with pytest.raises(ValueError, match="max exact K"):
        ops.int_gemm(a, b, w=14, exact=True)
    with pytest.raises(ValueError, match="unknown backend"):
        ops.int_gemm(a, b, w=8, backend="xla")
    oracle = ref_int_gemm_i64(a.numpy(), b.numpy())
    got = ops.int_gemm(a, b, w=8, backend="aten", exact=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_ops.int_gemm(
        jnp.asarray(a.numpy()), jnp.asarray(b.numpy()), w=8, backend="xla",
        exact=True)))
    for variant in ("xla_ref", "ffip", "strassen", "strassen+kmm2"):
        plan = ExecPlan(variant, 8, combine_int32=True)
        assert space.validate(plan, (8, 4096, 8)) is None
        got = ops.run_plan(a, b, plan=plan)
        np.testing.assert_array_equal(got.numpy().astype(np.int64), oracle,
                                      err_msg=variant)
    with pytest.raises(NotImplementedError, match="aten"):
        ops.run_plan(a, b, plan=ExecPlan("kmm2", 28, depth=3))


def test_wrappers_validate_inputs():
    i8 = torch.zeros((4, 8), dtype=torch.int8)
    j8 = torch.zeros((8, 3), dtype=torch.int8)
    with pytest.raises(ValueError):
        mm1_gemm.mm1_gemm(i8, j8[:4])                   # K mismatch
    with pytest.raises(TypeError):
        mm1_gemm.mm1_gemm(i8.to(torch.int16), j8.to(torch.int16))
    with pytest.raises(ValueError):                     # pre-adder past s8
        kmm_gemm.kmm2_gemm_planes(i8, i8, j8, j8, h=8)
    with pytest.raises(TypeError):                      # mixed plane types
        kmm_gemm.kmm2_gemm_planes(i8, i8.to(torch.int16), j8, j8, h=4)
    with pytest.raises(TypeError):                      # mm2 takes int8
        mm2_gemm.mm2_gemm_planes(*(t.to(torch.int16)
                                   for t in (i8, i8, j8, j8)), h=4)
    with pytest.raises(ValueError):
        mm2_gemm.mm2_gemm_planes(i8, i8, j8, j8, h=9)
    assert kmm_gemm.route(torch.int8, 7) == "s8"
    assert kmm_gemm.route(torch.int16, 6) == "s8"
    assert kmm_gemm.route(torch.int16, 7) == "split"
