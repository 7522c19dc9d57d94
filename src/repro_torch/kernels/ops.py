"""The execution seam of the integer GEMM: plan selection, the fused kernel
and the staged digit-plane path (port of ``repro.kernels.ops``).

``int_gemm(a, b, w=...)`` is the production API: signed w-bit integer
operands multiplied through the plan :func:`repro_torch.core.dispatch
.select_plan` resolves — the analytic one (the fused kernel), or an
installed tuning table's winner — and :func:`run_plan` executes one
:class:`~repro_torch.core.dispatch.ExecPlan`:

  * ``fused`` / ``fused_mm2``: the fused kernel (``fused_gemm``), raw
    int32 or fp32 output;
  * ``mm1`` / ``kmm2`` / ``mm2`` on ``"cuda"``: the staged path
    :func:`_int_gemm_cuda`.
    It pads K to the plan's ``block_k`` (``kp`` enters the fp32 numerics),
    splits the operands into centered s8 digit planes in device memory,
    launches one digit kernel (``mm1_gemm``, ``kmm2_gemm_planes``,
    ``mm2_gemm_planes``; three ``kmm2_gemm_planes`` on int16 branch planes
    at depth 2, :func:`_kmm4_core`), and applies the Section IV-D
    zero-point correction

        A@B = Abar@Bbar + z*rowsum(Abar) + z*colsum(Bbar) + kp*z^2

    with the int32 sums wrapping modulo 2^32, as the reference's do.

The ATen route (backend ``"aten"``, the reference's ``"xla"``):

  * ``mm1`` / ``kmm2`` / ``mm2`` on ``"aten"``: :func:`_int_gemm_aten`,
    the digit recursion ``kmm_n`` / ``mm_n`` of :mod:`repro_torch.core.kmm`
    on the raw (uncentered) digits of the unpadded operands, int32 or fp32
    combine, at any depth;
  * ``xla_ref``: the exact int32 product; ``ffip``: the literal FFIP
    (:mod:`repro_torch.kernels.ffip`);
  * ``strassen`` / ``strassen+kmm2`` (:mod:`repro_torch.core.strassen`):
    seven sub-GEMMs that re-enter :func:`run_plan`, on the ATen route's
    exact plan or the fused kernel.

``run_plan(..., use_ref_kernels=True)`` swaps each kernel for its plain
version (:mod:`repro_torch.kernels.ref`) around the identical padding,
split and correction: the bit-exact mirror the autotuner checks fp32
candidates against.  For a fused plan the mirror is the staged path with
the plan's mode and depth — the fused kernel runs the same fp32 operation
sequence.  The mirror flag passes through Strassen's sub-GEMMs.
"""
from __future__ import annotations

from dataclasses import replace
from typing import Optional

import torch

from repro_torch.core.context import BACKENDS
from repro_torch.core.dispatch import ExecPlan, Mode, select_plan
from repro_torch.core.kmm import (MATMUL_DIMS, default_mm1, kmm_n,
                                  max_exact_k, mm_n)
from repro_torch.core.strassen import STRASSEN_VARIANTS, strassen_matmul
from repro_torch.kernels.ffip import ffip_gemm_literal
from repro_torch.kernels.fused_gemm import _kmm2_f32, _wrap_int32, fused_gemm
from repro_torch.kernels.kmm_gemm import kmm2_gemm_planes
from repro_torch.kernels.mm1_gemm import mm1_gemm
from repro_torch.kernels.mm2_gemm import mm2_gemm_planes
from repro_torch.kernels.ref import (ref_int_gemm, ref_kmm2_planes,
                                     ref_mm2_planes)
from repro_torch.kernels.ref import split_planes as _planes
from repro_torch.obs import trace as obs_trace


def _pad_to(x: torch.Tensor, mult0: int, mult1: int) -> torch.Tensor:
    p0 = (-x.shape[0]) % mult0
    p1 = (-x.shape[1]) % mult1
    if p0 or p1:
        x = torch.nn.functional.pad(x, (0, p1, 0, p0))
    return x


def int_gemm(a: torch.Tensor, b: torch.Tensor, *, w: int, m: int = 8,
             backend: str = "cuda", exact: bool = False,
             block_k: Optional[int] = None, plan: Optional[ExecPlan] = None,
             context=None) -> torch.Tensor:
    """Integer GEMM with precision-scalable dispatch (paper Fig. 10).

    a: (M, K) signed w-bit values in an integer dtype; b: (K, N) likewise.
    Returns float32 (or int32 when ``exact=True``, which requires
    K <= ``max_exact_k(w)`` and uses integer combines).

    The plan is the context's or the active tuning table's winner for this
    (backend, M/K/N bucket, w) key, else the analytic plan (the fused
    kernel, ``block_k`` 256); an explicit ``block_k`` wins.  ``plan``
    bypasses selection and runs the given plan (the autotuner's entry).
    Under ``context.mesh`` a ``"cuda"`` plan runs sharded
    (:func:`run_plan`); the mesh is never taken from the ambient one here,
    so the collectives' chunk GEMMs stay on their own rank.
    """
    if context is not None:
        backend = context.backend
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; choices {BACKENDS}")
    m_dim, k_dim = a.shape
    n_dim = b.shape[1]
    if exact and max_exact_k(w) < k_dim:
        raise ValueError(
            f"exact int32 output impossible for w={w}, K={k_dim}; "
            f"max exact K is {max_exact_k(w)}")
    if plan is None:
        plan = select_plan((m_dim, k_dim, n_dim), w, m=m, backend=backend,
                           exact=exact, context=context)
        if block_k is not None:
            plan = replace(plan, block_k=block_k)
    out = run_plan(a, b, plan=plan,
                   mesh=context.mesh if context is not None else None)
    if exact or out.dtype == torch.float32:
        return out
    return out.to(torch.float32)


def run_plan(a: torch.Tensor, b: torch.Tensor, *, plan: ExecPlan,
             use_ref_kernels: bool = False, mesh=None) -> torch.Tensor:
    """Execute one :class:`ExecPlan` on (M, K) x (K, N) integer operands.

    Output dtype follows the plan: int32 for exact-int plans, float32 for
    fp32-combine plans.  ``use_ref_kernels`` runs the kernels' plain
    versions inside the identical padding and correction — bit-identical,
    the tuner's oracle.  CUDA operands launch the kernels; CPU operands run
    the plain versions whatever the flag.

    With tracing enabled the call records a ``run_plan`` span (variant, w,
    backend, depth, shape), as the reference's does: host time, so on CUDA
    the time to launch the plan's kernels, not their device time.

    With ``mesh`` and a ``"cuda"`` plan the plan runs
    sharded (:func:`repro_torch.dist.shard_gemm.sharded_run_plan`): each
    rank runs the same kernel — fused or staged — on its block, on the
    axes ``plan.shard`` names (negotiated where unset).
    """
    if mesh is not None and plan.backend == "cuda":
        from repro_torch.dist.shard_gemm import sharded_run_plan
        return sharded_run_plan(a, b, plan=plan, mesh=mesh,
                                use_ref_kernels=use_ref_kernels)
    if plan.shard is not None:
        plan = replace(plan, shard=None)
    if not obs_trace.enabled():
        return _run_plan_impl(a, b, plan=plan,
                              use_ref_kernels=use_ref_kernels)
    with obs_trace.span("run_plan", variant=plan.variant, w=plan.w,
                        backend=plan.backend, depth=plan.depth,
                        shape=f"{a.shape[0]}x{a.shape[1]}x{b.shape[-1]}"):
        return _run_plan_impl(a, b, plan=plan,
                              use_ref_kernels=use_ref_kernels)


def _run_plan_impl(a: torch.Tensor, b: torch.Tensor, *, plan: ExecPlan,
                   use_ref_kernels: bool) -> torch.Tensor:
    if plan.variant in STRASSEN_VARIANTS:
        def run_sub(x, y, sub_plan):
            return run_plan(x, y, plan=sub_plan,
                            use_ref_kernels=use_ref_kernels)
        return strassen_matmul(a, b, plan=plan, run_sub=run_sub)
    if plan.variant == "xla_ref":
        return default_mm1()(a.to(torch.int32), b.to(torch.int32),
                             MATMUL_DIMS, bits=plan.w)
    if plan.variant == "ffip":
        return ffip_gemm_literal(a, b)
    if plan.variant in ("fused", "fused_mm2"):
        if use_ref_kernels:
            return _int_gemm_cuda(a, b, plan=plan, use_ref_kernels=True)
        mode = ("mm2" if plan.variant == "fused_mm2" else
                "kmm4" if plan.depth == 2 else "auto")
        return fused_gemm(a.contiguous(), b.contiguous(), w=plan.w,
                          m=plan.m, mode=mode, block_k=plan.block_k,
                          combine_int32=plan.combine_int32)
    if plan.backend == "aten":
        return _int_gemm_aten(a, b, plan=plan)
    return _int_gemm_cuda(a, b, plan=plan, use_ref_kernels=use_ref_kernels)


def _int_gemm_aten(a: torch.Tensor, b: torch.Tensor, *,
                   plan: ExecPlan) -> torch.Tensor:
    """The ATen route (the reference's ``_int_gemm_xla``): the exact int32
    product in the MM1 window, else ``kmm_n`` / ``mm_n`` at the plan's
    digits on int32 operands, int32 or fp32 combine."""
    ai, bi = a.to(torch.int32), b.to(torch.int32)
    if plan.mode is Mode.MM1:
        return default_mm1()(ai, bi, MATMUL_DIMS, bits=plan.w)
    fn = kmm_n if plan.mode is Mode.KMM2 else mm_n
    combine = torch.int32 if plan.combine_int32 else torch.float32
    return fn(ai, bi, w=plan.w, n=plan.digits, combine_dtype=combine)


def _int_gemm_cuda(a: torch.Tensor, b: torch.Tensor, *, plan: ExecPlan,
                   use_ref_kernels: bool = False) -> torch.Tensor:
    """The staged path (the reference's ``_int_gemm_pallas``): pad K, split
    planes, one digit kernel (three at depth 2), the zero-point correction.
    M and N are not padded: the kernels take any M and N.

    The operands are carried in the narrowest type their w-bit values and
    the split's intermediates fit — int8 for MM1, int16 through w = 16,
    int32 above, the carriers the quantizer stores — where the reference
    widens everything to int32: the same values, so the same result, and
    a caller passing carrier codes (the quantized matmul) pays no widening
    copy.  A becomes row-major.  The MM1, KMM2 and MM2 kernels take B
    row-major or K-major, so B keeps its layout: it is used as it is where
    it needs no padding or cast (the tied ``lm_head`` weight arrives as the
    K-major view ``embed.T`` and is not copied), padded or cast in its own
    layout where it does, and the digit planes, elementwise functions of
    B, come out in B's layout too.  Nothing transposes B: a transposing
    copy on the card costs far more than the kernel gains from K-major
    planes."""
    exact = plan.combine_int32
    carrier = (torch.int8 if plan.mode is Mode.MM1 else
               torch.int16 if plan.w <= 16 else torch.int32)
    a = _pad_to(a.to(carrier), 1, plan.block_k).contiguous()
    if not b.is_contiguous() and b.t().is_contiguous():
        # K-major B stays K-major (copied only to pad or cast)
        b = _pad_to(b.t().to(carrier), 1, plan.block_k).contiguous().t()
    else:
        b = _pad_to(b.to(carrier), plan.block_k, 1).contiguous()
    kp = a.shape[1]
    if plan.mode is Mode.MM1:
        fn = ref_int_gemm if use_ref_kernels else mm1_gemm
        return fn(a, b)
    h = -(-plan.w // 2)
    z = 1 << (h - 1)
    if plan.depth == 2 and plan.mode is Mode.KMM2:
        core = _kmm4_core(a, b, h=h, z=z, exact=exact,
                          use_ref_kernels=use_ref_kernels)
    elif plan.depth > 1:
        raise NotImplementedError(
            "the staged path implements KMM recursion up to depth 2 (plus "
            "single-level MM2), as the reference's Pallas path does; use "
            "backend 'aten' for deeper recursion")
    else:
        a1, a0, _ = _planes(a, h)
        b1, b0, _ = _planes(b, h)
        if use_ref_kernels:
            ref = ref_kmm2_planes if plan.mode is Mode.KMM2 \
                else ref_mm2_planes
            core = ref(a1, a0, b1, b0, h=h, combine_int32=exact)
        else:
            kernel = kmm2_gemm_planes if plan.mode is Mode.KMM2 \
                else mm2_gemm_planes
            core = kernel(a1, a0, b1, b0, h=h, combine_int32=exact)
    # Zero-point adjuster (paper Section IV-D): with abar = a - z
    # elementwise (padded zeros included) the correction sums come straight
    # from the padded operands, in int32 (modulo 2^32).
    row = _wrap_int32(a.sum(dim=1, keepdim=True) - kp * z)   # rowsum(abar)
    col = _wrap_int32(b.sum(dim=0, keepdim=True) - kp * z)   # colsum(bbar)
    if exact:
        corr = z * row.to(torch.int64) + z * col.to(torch.int64) + z * z * kp
        return _wrap_int32(core.to(torch.int64) + corr)
    f32 = torch.float32
    corr = ((row.to(f32) * float(z) + col.to(f32) * float(z))
            + float(z) * float(z) * float(kp))
    return core + corr


def _kmm4_core(a: torch.Tensor, b: torch.Tensor, *, h: int, z: int,
               exact: bool, use_ref_kernels: bool) -> torch.Tensor:
    """Staged depth-2 KMM core on padded operands: three KMM2 plane
    launches at the level-2 split, then the level-1 combine.

    The level-1 centered split at ``h`` gives the branches {A1, A1+A0bar,
    A0bar} (each within h+1 signed bits); each branch is re-split plainly
    at ``h2 = ceil((h+1)/2)`` into int16 planes whose every value fits s8.
    The operation sequences match the fused kmm4 mode level for level, so
    the fp32 combines are bit-identical; the caller applies the one
    level-1 zero-point correction.  The B planes come out in B's layout.
    """
    mask = (1 << h) - 1
    a1 = a >> h
    a0 = (a & mask) - z
    b1 = b >> h
    b0 = (b & mask) - z
    h2 = -(-(h + 1) // 2)
    mask2 = (1 << h2) - 1

    def branch(av, bv):
        planes = [(av >> h2).to(torch.int16), (av & mask2).to(torch.int16),
                  (bv >> h2).to(torch.int16), (bv & mask2).to(torch.int16)]
        fn = ref_kmm2_planes if use_ref_kernels else kmm2_gemm_planes
        return fn(*planes, h=h2, combine_int32=exact)

    c11 = branch(a1, b1)
    css = branch(a1 + a0, b1 + b0)
    c00 = branch(a0, b0)
    if exact:
        c11, css, c00 = (c.to(torch.int64) for c in (c11, css, c00))
        return _wrap_int32((c11 << (2 * h)) + ((css - c11 - c00) << h)
                           + c00)
    return _kmm2_f32(c11, css, c00, h)
