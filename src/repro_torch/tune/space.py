"""Autotuning search space of the integer GEMM (port of
``repro.tune.space``).

A point is an :class:`~repro_torch.core.dispatch.ExecPlan`: kernel variant,
``block_k``, combine precision (int32 post-adder or fp32) and
digit-recursion depth.  ``validate`` holds every variant on both backends
to the provable bounds — the ``max_exact_k`` int32 headroom, the s8 digit
windows of the paper's Fig. 10 rule, the per-digit accumulator headroom,
Strassen's composed bound (``strassen_k_bound``) and the ``block_k``
sanity rule — so a table entry that fails them is never run.
``candidates`` enumerates the valid points of the kernel variants
(``dispatch.KERNEL_VARIANTS`` on ``"cuda"``: ``mm1``, ``kmm2``, ``mm2``
staged; ``fused``, ``fused_mm2``) for one (M, K, N, w) problem — a table
may hold any valid plan, but the tuner sweeps these — and ``cost_prior``
ranks them with the op counts of :mod:`repro_torch.core.complexity`.

Against the reference, the M/N tiles and the VMEM footprint go: the CUDA
kernels pick their own M/N tiles and hold fixed shared-memory tiles
whatever the plan (the staged MM1 and KMM2 kernels a four-stage ring of
37-138 KB by layout, plane type and tile; staged MM2 32 KB; fused kmm4 at
most 113 KB), so no plan can exceed them.  ``cost_prior`` keeps the reference's
terms at the reference's default M/N tiles, 128 x 128.

Pruning is a correctness filter, never a performance heuristic: every
candidate that survives ``validate`` equals the int64 oracle (exact plans)
or the ``use_ref_kernels`` mirror (fp32 plans) bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Sequence, Tuple

from repro_torch.core.complexity import (ADD, MULT, SHIFT, kmm_complexity,
                                         mm_complexity)
from repro_torch.core.context import BACKENDS
from repro_torch.core.dispatch import (VARIANTS, ExecPlan, analytic_plan,
                                       kmm_levels_needed,
                                       numerics_fingerprint)
from repro_torch.core.kmm import max_exact_k, plan_accum_k_bound
from repro_torch.core.strassen import (STRASSEN_VARIANTS, strassen_sub_plan,
                                       strassen_sub_shape)

Shape = Tuple[int, int, int]   # (M, K, N)

TILE_CHOICES: Tuple[int, ...] = (32, 64, 128, 256)   # block_k sweep
MAX_DEPTH = 3
# The FFIP literal materializes an (M, K/2, N) product tensor.
FFIP_MAX_ELEMS = 1 << 20
# The reference's default M/N tiles, at which cost_prior prices a plan.
PRIOR_BLOCK_M = PRIOR_BLOCK_N = 128

_N_ACCUM = {"mm1": 1, "kmm2": 3, "mm2": 4, "fused": 3, "fused_mm2": 4}


def _n_accum(plan: ExecPlan) -> int:
    """int32 digit accumulators a plan's kernel keeps live (fused depth 2
    runs 9 leaf products; the staged depth-2 path three KMM2 launches of 3
    accumulators each — the same count for the cost model)."""
    if plan.variant == "fused":
        return {0: 1, 1: 3, 2: 9}.get(plan.depth, 9)
    if plan.variant == "kmm2" and plan.depth == 2:
        return 9
    return _N_ACCUM.get(plan.variant, 1)


def _tile_ok(block: int, dim: int) -> bool:
    """A K tile is sane if it is not more than one doubling past K (the
    staged path zero-pads K up to the block multiple)."""
    return block <= 2 * max(dim, 1) or block == TILE_CHOICES[0]


def strassen_k_bound(plan: ExecPlan) -> int:
    """Largest full-problem K for which a strassen plan stays exact.

    The tile pre-adds give (w+1)-bit sub-operands contracting over
    ``Ks = ceil(K / 2)``, so every sub-plan bound applies at ``w + 1`` on
    the half K: the sub-product must fit int32 (``K <= 2 * max_exact_k(w +
    1) = 2**(30 - 2w)``, the binding term); a fused sub-plan's digit
    accumulators must stay exact (``Ks <= plan_accum_k_bound(sub)``); and
    the recombined output must fit int32 (``K <= max_exact_k(w)``, never
    binding).
    """
    sub = strassen_sub_plan(plan)
    bound = 2 * max_exact_k(sub.w)
    if sub.backend == "cuda":
        sub_accum = plan_accum_k_bound(sub)
        if sub_accum is not None:
            bound = min(bound, 2 * sub_accum)
    return min(bound, max_exact_k(plan.w))


def validate(plan: ExecPlan, shape: Shape) -> Optional[str]:
    """A rejection reason, or None if ``plan`` is valid for ``shape``.

    Every rule is a hard correctness or feasibility bound: a rejected plan
    may overflow int32 or produce wrong digits.
    """
    M, K, N = shape
    w, m = plan.w, plan.m
    if plan.variant not in VARIANTS:
        return f"unknown variant {plan.variant!r}"
    if m < 2:
        return f"m={m} < 2"
    if w < 1:
        return f"w={w} < 1"
    if plan.backend not in BACKENDS:
        return f"unknown backend {plan.backend!r}"

    if plan.variant == "xla_ref":
        # one exact int32 product: the full 2w-bit products accumulate
        # directly, so the max_exact_k headroom binds
        if max_exact_k(w) < K:
            return (f"xla_ref overflows int32: K={K} > "
                    f"max_exact_k={max_exact_k(w)}")
        if not plan.combine_int32:
            return "xla_ref is inherently exact; combine_int32 must be True"
        return None
    if plan.variant == "ffip":
        if K % 2:
            return "ffip needs even K"
        if M * (K // 2) * N > FFIP_MAX_ELEMS:
            return "ffip literal materializes (M, K/2, N); shape too large"
        # (a_e + b_o)(a_o + b_e) are (w+1)-bit x (w+1)-bit products
        if max_exact_k(w + 1) < K:
            return f"ffip overflows int32 at K={K} for w={w}"
        if not plan.combine_int32:
            return "ffip is inherently exact; combine_int32 must be True"
        return None
    if plan.variant in STRASSEN_VARIANTS:
        if plan.depth != 1:
            return f"strassen is one tile-split level, got depth {plan.depth}"
        if not plan.combine_int32:
            return ("strassen combines are int32 ring arithmetic; "
                    "combine_int32 must be True")
        if plan.variant == "strassen+kmm2" and plan.backend != "cuda":
            return "strassen+kmm2 runs fused sub-GEMMs; cuda only"
        bound = strassen_k_bound(plan)
        if K > bound:
            return (f"strassen sub-products overflow int32: K={K} > "
                    f"composed bound {bound} (= 2*max_exact_k({w + 1}) "
                    f"after the one-bit pre-add growth)")
        sub = strassen_sub_plan(plan)
        reason = validate(sub, strassen_sub_shape(shape))
        if reason is not None:
            return f"strassen sub-GEMM (w={sub.w}) invalid: {reason}"
        return None
    if plan.variant in ("fused", "fused_mm2") and plan.backend != "cuda":
        return f"{plan.variant} is the fused kernel: cuda only"
    if plan.variant == "mm1" and plan.backend == "aten":
        return "mm1 on aten is the xla_ref variant"
    if plan.backend == "aten":      # the digit recursion on ATen leaves
        if w < 2:
            return "digit split needs w >= 2"
        if plan.depth < 1 or plan.depth > MAX_DEPTH:
            return f"depth {plan.depth} outside [1, {MAX_DEPTH}]"
        if 2 ** plan.depth > w:
            return f"depth {plan.depth} splits below 1-bit digits at w={w}"
        r_min = kmm_levels_needed(w, m)
        if r_min is None:
            return f"w={w} too wide for m={m}"
        if plan.depth < max(r_min, 1):
            return f"depth {plan.depth} leaves digits wider than m={m}"
        if plan.combine_int32 and max_exact_k(w) < K:
            return (f"int32 combine fails headroom: K={K} > "
                    f"max_exact_k({w})={max_exact_k(w)}")
        return None

    if plan.variant == "fused":
        # In-kernel split, correction and epilogue: the MM1 window (w <= m,
        # depth 0), single-level KMM2 (depth 1) and 4-digit KMM (depth 2,
        # any w whose depth-2 leaves fit the multiplier).
        if w <= m:
            if plan.depth != 0:
                return f"fused MM1 window is depth 0, got {plan.depth}"
            if not plan.combine_int32:
                return ("fused MM1-window core is inherently exact; "
                        "combine_int32 must be True")
            if max_exact_k(w) < K:
                return (f"fused mm1 overflows int32: K={K} > "
                        f"max_exact_k={max_exact_k(w)}")
        else:
            if plan.depth not in (1, 2):
                return ("fused KMM window implements depth 1 or 2, got "
                        f"{plan.depth}")
            if plan.depth == 1 and w > 2 * m - 2:
                return (f"fused kmm2 pre-adder digits exceed s8 for "
                        f"w={w} > {2*m - 2}")
            if plan.depth == 2:
                r_min = kmm_levels_needed(w, m)
                if r_min is None or r_min > 2:
                    return (f"depth-2 leaves exceed the m={m} multiplier "
                            f"at w={w}")
                if w < 4:
                    return f"depth 2 splits below 1-bit digits at w={w}"
            reason = _accum_reason(plan, K)
            if reason:
                return reason
            if plan.combine_int32 and max_exact_k(w) < K:
                return (f"int32 combine fails headroom: K={K} > "
                        f"max_exact_k({w})={max_exact_k(w)}")
    elif plan.variant == "fused_mm2":
        # The 4-pass conventional mode: no pre-adder, so the digits fit the
        # multiplier through w <= 2m.
        if plan.depth != 1:
            return f"fused_mm2 is single-level, got depth {plan.depth}"
        if w <= m:
            return f"fused_mm2 needs w > m ({w} <= {m})"
        if w > 2 * m:
            return (f"mm2 digit planes exceed the multiplier for "
                    f"w={w} > {2*m}")
        reason = _accum_reason(plan, K)
        if reason:
            return reason
        if plan.combine_int32 and max_exact_k(w) < K:
            return (f"int32 combine fails headroom: K={K} > "
                    f"max_exact_k({w})={max_exact_k(w)}")
    elif plan.variant == "mm1":
        if w > m:
            return f"mm1 needs w <= m ({w} > {m})"
        if not plan.combine_int32:
            return "mm1 is inherently exact; combine_int32 must be True"
        if max_exact_k(w) < K:
            return (f"mm1 overflows int32: K={K} > "
                    f"max_exact_k={max_exact_k(w)}")
    else:  # staged kmm2 / mm2 on digit planes
        if w < 2:
            return "digit split needs w >= 2"
        if plan.depth < 1 or plan.depth > MAX_DEPTH:
            return f"depth {plan.depth} outside [1, {MAX_DEPTH}]"
        if 2 ** plan.depth > w:
            return f"depth {plan.depth} splits below 1-bit digits at w={w}"
        if plan.variant == "mm2" and plan.depth != 1:
            return "staged mm2 is single-level"
        if plan.variant == "kmm2" and plan.depth not in (1, 2):
            return "staged kmm2 implements depth 1 or 2"
        if plan.variant == "kmm2" and plan.depth == 1 and w > 2 * m - 2:
            # the paper's Fig. 10 window: As = A1 + A0 must fit m bits
            return f"kmm2 pre-adder digits exceed s8 for w={w} > {2*m - 2}"
        if plan.variant == "kmm2" and plan.depth == 2:
            r_min = kmm_levels_needed(w, m)
            if r_min is None or r_min > 2:
                return (f"depth-2 leaves exceed the m={m} multiplier "
                        f"at w={w}")
        if plan.variant == "mm2" and w > 2 * m:
            return f"mm2 digit planes exceed s8 for w={w} > {2*m}"
        reason = _accum_reason(plan, K)
        if reason:
            return reason
        if plan.combine_int32 and max_exact_k(w) < K:
            return (f"int32 combine fails headroom: K={K} > "
                    f"max_exact_k({w})={max_exact_k(w)}")

    bk = plan.block_k
    if bk < 8 or bk & (bk - 1):
        return f"block_k={bk} must be a power of two >= 8"
    if not _tile_ok(bk, K):
        return f"block_k={bk} oversized for dim {K}"
    return None


def _accum_reason(plan: ExecPlan, K: int) -> Optional[str]:
    kp = -(-K // plan.block_k) * plan.block_k
    bound = plan_accum_k_bound(plan)
    if bound is not None and kp > bound:
        return f"digit accumulators overflow int32: padded K={kp} > {bound}"
    return None


def candidates(shape: Shape, w: int, *, m: int = 8, backend: str = "cuda",
               tile_choices: Optional[Sequence[int]] = None
               ) -> Iterator[ExecPlan]:
    """Enumerate the valid candidates of the kernel variants for one GEMM
    problem, in the reference's order (per ``block_k``: mm1, fused,
    fused_mm2, then the staged kmm2 at depths 1 and 2 and mm2)."""
    if backend != "cuda":
        raise ValueError(f"the port tunes backend 'cuda', not {backend!r}")
    tiles = tuple(tile_choices) if tile_choices else TILE_CHOICES

    def emit(plan: ExecPlan) -> Iterator[ExecPlan]:
        if validate(plan, shape) is None:
            yield plan

    for bk in tiles:
        yield from emit(ExecPlan("mm1", w, m, backend=backend, block_k=bk,
                                 combine_int32=True, depth=0,
                                 source="space"))
        for depth in ((0,) if w <= m else (1, 2)):
            for ci in ((True,) if w <= m else (False, True)):
                yield from emit(ExecPlan("fused", w, m, backend=backend,
                                         block_k=bk, combine_int32=ci,
                                         depth=depth, source="space"))
        for ci in (False, True):
            yield from emit(ExecPlan("fused_mm2", w, m, backend=backend,
                                     block_k=bk, combine_int32=ci, depth=1,
                                     source="space"))
        for variant, depth in (("kmm2", 1), ("kmm2", 2), ("mm2", 1)):
            for ci in (False, True):
                yield from emit(ExecPlan(variant, w, m, backend=backend,
                                         block_k=bk, combine_int32=ci,
                                         depth=depth, source="space"))


def cost_prior(plan: ExecPlan, shape: Shape) -> float:
    """Analytic cost of a plan, in weighted op units: the paper's
    complexity recursions (Eqs. 2 and 5 at d = 1 give per-product counts:
    3**r multiplies per product for KMM, 4**r for MM, and the per-output
    combine adds and shifts) scaled to the padded problem, the staged
    kernels' plane traffic, the fused kernel's re-split per reuse, and a
    per-tile overhead — at the reference's 128 x 128 M/N tiles."""
    M, K, N = shape
    bm, bn, bk = PRIOR_BLOCK_M, PRIOR_BLOCK_N, plan.block_k
    Mp, Np, Kp = (-(-M // bm) * bm, -(-N // bn) * bn, -(-K // bk) * bk)
    grid = (Mp // bm) * (Np // bn) * (Kp // bk)
    n = max(plan.digits, 1)
    if plan.variant == "mm1" or n == 1:
        mults, combine = float(Mp * Np * Kp), 0.0
    else:
        fn = kmm_complexity if plan.variant in ("kmm2", "fused") \
            else mm_complexity
        ops = fn(n, plan.w, 1)            # d=1: per-product / per-output
        mults = ops.total_of(MULT) * Mp * Np * Kp
        combine = (ops.total_of(ADD) + ops.total_of(SHIFT)) * Mp * Np
    # fp32 combine costs one extra cast/round per accumulator per output.
    if not plan.combine_int32 \
            and plan.variant in ("kmm2", "mm2", "fused", "fused_mm2"):
        combine += _n_accum(plan) * Mp * Np
    # The staged kernels materialize the digit planes in device memory
    # (twice as many at depth 2); the fused kernel splits in registers but
    # re-splits each operand tile once per reuse across the other axis.
    if plan.variant in ("kmm2", "mm2"):
        combine += 3.0 * (plan.digits // 2) * (Mp * Kp + Kp * Np)
    elif plan.variant in ("fused", "fused_mm2") and plan.w > plan.m:
        combine += 0.5 * (Mp * Kp * (Np // bn) + Kp * Np * (Mp // bm))
    return mults + combine + 512.0 * grid


def pruned_space(shape: Shape, w: int, *, m: int = 8, backend: str = "cuda",
                 tile_choices: Optional[Sequence[int]] = None
                 ) -> List[ExecPlan]:
    """The valid candidates for ``shape``/``w``, best prior first."""
    cands = list(candidates(shape, w, m=m, backend=backend,
                            tile_choices=tile_choices))
    return sorted(cands, key=lambda p: cost_prior(p, shape))


def prior_plan(shape: Shape, w: int, *, m: int = 8, backend: str = "cuda",
               exact: bool = False) -> Optional[ExecPlan]:
    """Best candidate by the cost prior alone (no measurement) — the table
    fallback for a key never swept — among the candidates in the analytic
    plan's numerics class, so untuned keys keep the analytic numerics.
    None on ``"aten"``, which the tuner does not sweep: a GEMM there runs
    its analytic plan, whose numerics every plan of its class shares."""
    if backend != "cuda":
        return None
    want = numerics_fingerprint(analytic_plan(w, m, backend=backend,
                                              exact=exact))
    best, best_cost = None, None
    for cand in candidates(shape, w, m=m, backend=backend):
        if numerics_fingerprint(cand) != want:
            continue
        c = cost_prior(cand, shape)
        if best_cost is None or c < best_cost:
            best, best_cost = cand, c
    if best is not None:
        best = dataclasses.replace(best, source="prior")
    return best


def _round_pow2(x: int, lo: int = 8) -> int:
    v = lo
    while v < x:
        v *= 2
    return v


def bucket_shape(shape: Shape) -> Shape:
    """Power-of-two M/K/N buckets used as table keys (min bucket 8)."""
    return tuple(_round_pow2(int(d)) for d in shape)  # type: ignore


def local_shape(shape: Shape, mesh) -> Shape:
    """Per-rank (M, K, N) of a GEMM under ``mesh``'s sharded layout (M over
    the data axes, N over ``model``, K replicated; see
    :mod:`repro_torch.dist.shard_gemm`), or the shape itself where the mesh
    cannot tile the GEMM (its ATen fallback runs the whole GEMM).  Tables
    are keyed, and bounds checked, on this shape under a mesh."""
    from repro_torch.dist.shard_gemm import local_shape as _local
    from repro_torch.dist.shard_gemm import negotiate
    spec, _ = negotiate(shape, mesh)
    if spec is None:
        return shape
    return _local(shape, spec, mesh)


def gemm_kn(cfg) -> List[Tuple[int, int]]:
    """The (K, N) of every quantized GEMM of a model config, sorted."""
    d = cfg.d_model
    kns = {(d, cfg.q_dim), (d, cfg.kv_dim), (cfg.q_dim, d),
           (d, cfg.padded_vocab)}
    if cfg.n_experts:
        fe = cfg.d_ff_expert or cfg.d_ff
        kns |= {(d, cfg.n_experts), (d, fe), (fe, d)}
    if not all(b.moe for b in cfg.pattern):
        kns |= {(d, cfg.d_ff), (cfg.d_ff, d)}
    if any(b.kind == "mamba" for b in cfg.pattern):
        di, dtr = cfg.expand * d, -(-d // 16)
        kns |= {(d, 2 * di), (di, dtr + 2 * cfg.d_state), (dtr, di),
                (di, d)}
    return sorted(kns)
