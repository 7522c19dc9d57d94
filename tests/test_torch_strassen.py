"""One tile-level Strassen split (``core/strassen.py``) against the
reference's ``repro.core.strassen`` and the int64 oracle, mirroring
tests/test_strassen.py: both variants (``strassen`` on the ATen route's
exact plan at w+1, ``strassen+kmm2`` on the fused kernel's plain version
at w+1) ``array_equal`` to JAX's ``run_plan`` and to the oracle on odd and
even shapes, through the mirror too; the sub-plans, the composed K bound
and ``validate`` against the reference's; the brute-force boundary at
K-bound / K-bound+1; and a table that swaps strassen in without moving a
bit, through ``int_gemm`` and the quantized matmul.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import dispatch as jax_dispatch  # noqa: E402
from repro.core import strassen as jax_strassen  # noqa: E402
from repro.kernels import ops as jax_ops  # noqa: E402
from repro.tune import space as jax_space  # noqa: E402
from repro_torch.core.dispatch import (ExecPlan, analytic_plan,  # noqa: E402
                                       numerics_fingerprint, select_plan)
from repro_torch.core.kmm import plan_accum_k_bound  # noqa: E402
from repro_torch.core.strassen import (STRASSEN_VARIANTS,  # noqa: E402
                                       strassen_sub_plan, strassen_sub_shape)
from repro_torch.kernels import fused_gemm as fg  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import ref_int_gemm_i64  # noqa: E402
from repro_torch.quant.qmatmul import quantized_matmul  # noqa: E402
from repro_torch.tune import space  # noqa: E402
from repro_torch.tune.table import TuningTable, use_table  # noqa: E402


def _plan(variant, w, m=8, block_k=32):
    backend = "aten" if variant == "strassen" else "cuda"
    return ExecPlan(variant, w, m, backend=backend, block_k=block_k,
                    combine_int32=True, depth=1)


def _jax_plan(p: ExecPlan, tiles=(32, 32)):
    backend = "xla" if p.backend == "aten" else "pallas"
    return jax_dispatch.ExecPlan(p.variant, p.w, p.m, backend=backend,
                                 block_m=tiles[0], block_n=tiles[1],
                                 block_k=p.block_k,
                                 combine_int32=p.combine_int32, depth=p.depth)


def _proj(p):
    backend = {"xla": "aten", "pallas": "cuda"}.get(p.backend, p.backend)
    return (p.variant, p.w, p.m, backend, p.block_k, p.combine_int32,
            p.depth)


@pytest.mark.parametrize("w,m", [(4, 4), (9, 8), (12, 8)])
@pytest.mark.parametrize("shape", [(7, 33, 5), (16, 64, 16), (30, 50, 18)])
def test_strassen_matches_jax_and_oracle(w, m, shape):
    rng = np.random.default_rng(w * 100 + shape[1])
    lim = 1 << (w - 1)
    a = rng.integers(-lim, lim, size=shape[:2], dtype=np.int32)
    b = rng.integers(-lim, lim, size=(shape[1], shape[2]), dtype=np.int32)
    oracle = ref_int_gemm_i64(a, b)
    fg.reset_launches()
    for variant in STRASSEN_VARIANTS:
        plan = _plan(variant, w, m)
        assert space.validate(plan, shape) is None
        assert jax_space.validate(_jax_plan(plan), shape) is None
        got = ops.run_plan(torch.from_numpy(a), torch.from_numpy(b),
                           plan=plan)
        ref = np.asarray(jax_ops.run_plan_jit(jnp.asarray(a), jnp.asarray(b),
                                              _jax_plan(plan)))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), ref, err_msg=variant)
        np.testing.assert_array_equal(got.numpy().astype(np.int64), oracle)
        mirror = ops.run_plan(torch.from_numpy(a), torch.from_numpy(b),
                              plan=plan, use_ref_kernels=True)
        assert torch.equal(mirror, got)
    assert not any(fg.launches.values())          # CPU: plain versions


def test_strassen_sub_plans_match_reference():
    for w, m in ((4, 4), (7, 8), (8, 8), (9, 8), (12, 8), (13, 8)):
        for variant in STRASSEN_VARIANTS:
            got = strassen_sub_plan(_plan(variant, w, m))
            ref = jax_strassen.strassen_sub_plan(_jax_plan(_plan(variant, w,
                                                                 m)))
            assert _proj(got) == _proj(ref), (variant, w, m)
    sk = strassen_sub_plan(_plan("strassen+kmm2", 9))
    assert (sk.variant, sk.w, sk.depth, sk.backend, sk.combine_int32) == \
        ("fused", 10, 1, "cuda", True)
    assert strassen_sub_plan(_plan("strassen+kmm2", 7)).depth == 0
    sx = strassen_sub_plan(_plan("strassen", 7))
    assert (sx.variant, sx.backend) == ("xla_ref", "aten")
    assert strassen_sub_shape((7, 33, 5)) == (4, 17, 3)
    with pytest.raises(ValueError):
        strassen_sub_plan(ExecPlan("fused", 9))


def test_strassen_k_bound_and_validate_match_reference():
    """B(w) = 2 * max_exact_k(w + 1) = 2**(30 - 2w), the reference's
    composed bound, and validate's verdict on both sides of it."""
    for w, m in ((4, 4), (8, 8), (9, 8), (12, 8), (14, 8), (15, 8)):
        for variant in STRASSEN_VARIANTS:
            plan = _plan(variant, w, m)
            bound = space.strassen_k_bound(plan)
            assert bound == jax_space.strassen_k_bound(_jax_plan(plan))
            assert plan_accum_k_bound(plan) == bound
            for k in (64, 128, bound, bound + 1, 2 * bound + 2):
                if k < 1 or k > 1 << 23:
                    continue
                shape = (64, k, 64)
                got = space.validate(plan, shape)
                ref = jax_space.validate(_jax_plan(plan), shape)
                assert (got is None) == (ref is None), (variant, w, k, got,
                                                        ref)
    assert space.strassen_k_bound(_plan("strassen+kmm2", 12)) == 64
    assert space.strassen_k_bound(_plan("strassen+kmm2", 15)) == 0
    reason = space.validate(_plan("strassen", 12), (16, 65, 16))
    assert reason is not None and "strassen" in reason
    assert space.validate(ExecPlan("strassen+kmm2", 9, backend="aten",
                                   combine_int32=True), (8, 8, 8))
    assert space.validate(ExecPlan("strassen", 9, backend="aten"), (8, 8, 8))


# (w, m, M=N, block_k): geometries where the boundary K runs in seconds
_BOUNDARY = ((4, 4, 2, 65536), (8, 8, 16, 2048), (12, 8, 16, 32))


@pytest.mark.parametrize("w,m,mn,bk", _BOUNDARY)
def test_strassen_boundary_brute_force(w, m, mn, bk):
    """At the composed bound K = 2**(30-2w) all-max unsigned w-bit
    operands are exact through both variants and every sub-product fits
    int32; at K + 1 validate rejects the plan."""
    hi = (1 << w) - 1
    for variant in STRASSEN_VARIANTS:
        plan = _plan(variant, w, m, block_k=bk)
        k = space.strassen_k_bound(plan)
        assert k == 1 << (30 - 2 * w)
        assert space.validate(plan, (mn, k, mn)) is None
        reason = space.validate(plan, (mn, k + 1, mn))
        assert reason is not None and "strassen" in reason
        assert 4 * (-(-k // 2)) * hi * hi < 2 ** 31
        a = np.full((mn, k), hi, np.int32)
        b = np.full((k, mn), hi, np.int32)
        got = ops.run_plan(torch.from_numpy(a), torch.from_numpy(b),
                           plan=plan)
        np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                      ref_int_gemm_i64(a, b))


def test_strassen_fingerprint_is_the_exact_class():
    for variant in STRASSEN_VARIANTS:
        assert numerics_fingerprint(_plan(variant, 9)) == \
            numerics_fingerprint(analytic_plan(9, exact=True))


def _strassen_table():
    """Strassen at an exact key (a legal swap), at a key whose request is
    fp32 (refused by the numerics pin) and past the composed bound
    (discarded by validate) — the reference test's table."""
    t = TuningTable()
    t.put("cuda", (64, 64, 64), 12, _plan("strassen+kmm2", 12))
    t.put("cuda", (64, 32, 16), 8, _plan("strassen+kmm2", 8))
    t.put("cuda", (64, 128, 64), 12, _plan("strassen+kmm2", 12))
    return t


def test_table_swapping_strassen_cannot_move_bits():
    rng = np.random.default_rng(21)
    a = torch.from_numpy(rng.integers(-2048, 2048, (64, 64)).astype(np.int32))
    b = torch.from_numpy(rng.integers(-2048, 2048, (64, 64)).astype(np.int32))
    base = ops.int_gemm(a, b, w=12, exact=True)
    with use_table(_strassen_table()):
        plan = select_plan((64, 64, 64), 12, exact=True)
        assert plan.variant == "strassen+kmm2" and plan.source == "table"
        tuned = ops.int_gemm(a, b, w=12, exact=True)
        assert select_plan((64, 64, 64), 12).variant not in STRASSEN_VARIANTS
        assert select_plan((64, 128, 64), 12, exact=True).variant \
            not in STRASSEN_VARIANTS
    assert torch.equal(base, tuned)
    np.testing.assert_array_equal(base.numpy().astype(np.int64),
                                  ref_int_gemm_i64(a.numpy(), b.numpy()))


def test_quantized_matmul_bit_identical_with_strassen_table():
    """A strassen entry in the MM1 window's exact class is served through
    the staged redirect; the w=12 fp32 class refuses it.  Either way the
    output is the untabled one, as in the reference."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((4, 16, 32)).astype(np.float32))
    wm = torch.from_numpy(rng.standard_normal((32, 16)).astype(np.float32))
    for w_bits in (8, 12):
        base = quantized_matmul(x, wm, w_bits)
        with use_table(_strassen_table()):
            tuned = quantized_matmul(x, wm, w_bits)
        assert torch.equal(base, tuned), w_bits
