"""Precision-scalable execution-mode dispatch (paper Section IV-C, Fig. 10).

Port of ``repro.core.dispatch``: the paper's mode rule (``select_mode``) and
the analytic ``ExecPlan`` the fused kernel runs.  Given input bitwidth ``w``
and multiplier bitwidth ``m``:

  * ``w <= m``           -> MM1  (1 tile pass)
  * ``m < w <= 2m - 2``  -> KMM2 (3 tile passes)
  * ``2m - 2 < w <= 2m`` -> MM2  (4 tile passes)

and wider ``w`` recurses.  ``select_plan`` resolves the plan a GEMM runs:
the analytic one, or an installed tuning table's winner (``repro_torch.tune``)
pinned to the analytic plan's numerics, so a table changes speed, never a
value.  Two backends: ``"cuda"`` (the reference's ``"pallas"``: the
hand-written kernels) and ``"aten"`` (the reference's ``"xla"``: the digit
recursion of :mod:`repro_torch.core.kmm` on exact ATen leaf products).
The conventional-algebra counts (``conv_mults_per_product``,
``conv_recursion``), ``efficiency_roof`` and ``schedule`` feed the paper's
efficiency model (:mod:`repro_torch.core.efficiency`).
"""
from __future__ import annotations

import enum
import functools
import math
from dataclasses import dataclass, replace
from typing import List, Optional, Tuple

from repro_torch.obs import metrics as obs_metrics

# Plan resolutions by (variant, backend, bucketed shape, source).  Host
# Python: one hit per select_plan call (the quantized matmul memoizes its
# plans per table, so a GEMM counts once per table and shape, and a decode
# graph's GEMMs count at capture, never at a replay); a flag test when
# metrics are disabled.
_PLANS_SELECTED = obs_metrics.counter(
    "repro_plans_selected_total",
    "select_plan resolutions by variant/backend/bucketed shape",
    labels=("variant", "backend", "bucket", "source"))


class Mode(enum.Enum):
    MM1 = "mm1"
    KMM2 = "kmm2"
    MM2 = "mm2"


@dataclass(frozen=True)
class Plan:
    mode: Mode
    w: int            # input bitwidth
    m: int            # multiplier bitwidth
    passes: int       # tile-read passes of the precision-scalable unit
    digits: int       # n: digits per operand at this level
    recursion: int    # r = ceil(log2 n) levels used

    @property
    def mults_per_product(self) -> int:
        """m-bit multiplications per w-bit product (3^r for KMM, 4^r for
        MM)."""
        if self.mode is Mode.MM1:
            return 1
        base = 3 if self.mode is Mode.KMM2 else 4
        return base ** self.recursion


def kmm_levels_needed(w: int, m: int) -> int | None:
    """Minimum KMM recursion depth so every leaf digit fits m bits (each
    level maps width w -> ceil(w/2) + 1 on the widest branch)."""
    width, r = w, 0
    while width > m:
        width = -(-width // 2) + 1
        r += 1
        if r > 8:
            return None
    return r


def select_mode(w: int, m: int = 8) -> Plan:
    """The paper's single-level dispatch rule (Fig. 10 modes); ``w = 2m-1``
    lands in MM2 because the KMM2 pre-adder would need ``m + 1`` bits."""
    if m < 2:
        raise ValueError(f"multiplier bitwidth m must be >= 2, got m={m}")
    if w < 1:
        raise ValueError(f"bitwidth must be >= 1, got {w}")
    if w <= m:
        return Plan(Mode.MM1, w, m, passes=1, digits=1, recursion=0)
    if w <= 2 * m - 2:
        return Plan(Mode.KMM2, w, m, passes=3, digits=2, recursion=1)
    if w <= 2 * m:
        return Plan(Mode.MM2, w, m, passes=4, digits=2, recursion=1)
    r = kmm_levels_needed(w, m)
    if r is None:
        raise ValueError(f"w={w} too wide for m={m} multipliers at any depth")
    return Plan(Mode.KMM2, w, m, passes=3 ** r, digits=2 ** r, recursion=r)


def conv_mults_per_product(w: int, m: int) -> int:
    """m-bit mults a *conventional* algorithm (SM/MM) needs per w-bit
    product: 4**r with r = ceil(log2(ceil(w/m)))  (paper Eq. 13)."""
    return 4 ** conv_recursion(w, m)


def conv_recursion(w: int, m: int) -> int:
    n = -(-w // m)
    return math.ceil(math.log2(n)) if n > 1 else 0


def efficiency_roof(w: int, m: int) -> float:
    """Multiplier-compute-efficiency roof of the precision-scalable KMM
    architecture at width w (paper Eq. 15 + mode rule): conventional mult
    count divided by the mode's mult count."""
    return conv_mults_per_product(w, m) / select_mode(w, m).mults_per_product


def schedule(widths: List[int], m: int = 8) -> List[Plan]:
    """Plan a mixed-precision workload (one Plan per layer bitwidth)."""
    return [select_mode(w, m) for w in widths]


# Kernel variants of the reference's registry.  "mm1"/"kmm2"/"mm2" are the
# paper's modes: the staged kernels on digit planes on "cuda", the digit
# recursion on "aten"; "fused" the single-pass kernel (MM1 window at depth
# 0, KMM2 at depth 1, 4-digit KMM at depth 2), "fused_mm2" its 4-pass
# conventional mode; "xla_ref" the exact int32 product; "ffip" the literal
# free-pipeline inner product (tiny shapes only); "strassen" /
# "strassen+kmm2" one tile-level Strassen split whose 7 sub-GEMMs re-enter
# run_plan at w+1, on the ATen route's exact plan and on the fused kernel
# (core/strassen.py).
VARIANTS = ("mm1", "kmm2", "mm2", "fused", "fused_mm2", "xla_ref", "ffip",
            "strassen", "strassen+kmm2")

# Integer core, no fp32 combine anywhere.
_EXACT_VARIANTS = ("mm1", "xla_ref", "ffip", "strassen", "strassen+kmm2")

# The kernel variants: the ones the tuner sweeps, and whose recorded
# block_k a table may lend an fp32 plan (the strassen variants' tiles were
# chosen for the half-shape sub-GEMMs).
KERNEL_VARIANTS = ("mm1", "kmm2", "mm2", "fused", "fused_mm2")


@dataclass(frozen=True)
class GemmShardSpec:
    """How one GEMM's (M, K, N) dims map onto mesh axes.

    ``m_axes``/``n_axes`` shard the output tile grid: each rank runs the
    kernel on its local block with no arithmetic across ranks, so values
    equal the unsharded kernel's bit for bit.  ``k_axes`` splits the
    contraction into partial products summed by an all-reduce: exact for
    exact-int plans, a different fp32 rounding for fp32-combine plans,
    which is why ``k_axes`` enters :func:`numerics_fingerprint` and the
    model-facing negotiation (:mod:`repro_torch.dist.shard_gemm`) never
    proposes it.  ``e_axes``: the expert dim of a grouped GEMM."""

    m_axes: Tuple[str, ...] = ()
    n_axes: Tuple[str, ...] = ()
    k_axes: Tuple[str, ...] = ()
    e_axes: Tuple[str, ...] = ()


@dataclass(frozen=True)
class ExecPlan:
    """A resolved way to run one integer GEMM: kernel variant, backend,
    K tile, combine precision and digit-recursion depth.  Of the
    reference's tiles only ``block_k`` is kept: it fixes the padded K that
    the fp32 combine rounds with, while M/N tiles never change a value and
    the CUDA kernels pick their own."""

    variant: str             # one of VARIANTS
    w: int
    m: int = 8
    backend: str = "cuda"        # "cuda" | "aten"
    block_k: int = 256
    combine_int32: bool = False  # int32 post-adder (exact) vs fp32
    depth: int = 1               # digit-recursion levels (digits = 2**depth)
    source: str = "analytic"     # "analytic" | "table" | "prior" (+notes)
    # "none" (raw accumulator out) or "dequant": a call-site property that
    # enters the numerics fingerprint, never stored in tuning tables.
    epilogue: str = "none"
    # Mesh layout of a sharded run (repro_torch.dist.shard_gemm); None runs
    # unsharded.  A call-site property like ``epilogue``, never stored in
    # tuning tables.
    shard: Optional[GemmShardSpec] = None

    @property
    def digits(self) -> int:
        if self.variant == "fused":
            return 2 ** self.depth      # depth 0 in the MM1 window
        if self.variant == "fused_mm2":
            return 2
        return 2 ** self.depth if self.variant in ("kmm2", "mm2") else 1

    @property
    def mode(self) -> Optional[Mode]:
        if self.variant == "fused":
            return Mode.KMM2 if self.w > self.m else Mode.MM1
        if self.variant in ("mm2", "fused_mm2"):
            return Mode.MM2
        if self.variant == "kmm2":
            return Mode.KMM2
        if self.variant in ("mm1", "xla_ref"):
            return Mode.MM1
        return None

    @property
    def is_exact_int(self) -> bool:
        """True when the plan computes the exact integer product in int32."""
        if self.variant == "fused" and self.w <= self.m:
            return True
        return self.combine_int32 or self.variant in _EXACT_VARIANTS


def numerics_fingerprint(plan: ExecPlan):
    """Plans with equal fingerprints give bit-identical outputs on the same
    operands (both valid).  Exact-int plans all compute the same integer;
    fp32-combine plans are keyed by what changes rounding — variant, depth,
    backend and epilogue.  The fused kernel runs the staged kernels' fp32
    operation sequence, so "fused" shares the "kmm2" class and "fused_mm2"
    the "mm2" one.

    Sharding: M/N sharding replicates K, so every output element sees the
    unsharded kernel's full-K arithmetic and the spec is not part of the
    fingerprint; K sharding splits the fp32 accumulation, so
    ``shard.k_axes`` is part of an fp32 plan's fingerprint (exact-int plans
    sum int32 partials exactly and stay in the "exact" class)."""
    if plan.is_exact_int:
        return ("exact", plan.epilogue)
    variant = {"fused": "kmm2", "fused_mm2": "mm2"}.get(plan.variant,
                                                        plan.variant)
    k_axes = plan.shard.k_axes if plan.shard is not None else ()
    return ("fp32", variant, plan.depth, plan.backend, plan.epilogue, k_axes)


DEFAULT_BLOCK_K = 256


def analytic_plan(w: int, m: int = 8, *, backend: str = "cuda",
                  exact: bool = False) -> ExecPlan:
    """The paper's dispatch rule as an ExecPlan with the default K tile.

    On ``backend="cuda"`` (the counterpart of the reference's "pallas") every
    window through depth-2 recursion routes to the fused single-pass kernel:
    MM1 and KMM2 as "fused", the (2m-2, 2m] boundary as "fused_mm2", and
    4-digit recursion as "fused" at depth 2; depth 3 and more keeps the
    staged variant, which the ATen route runs.  On ``backend="aten"`` (the
    reference's "xla") the plan is the mode's variant at ``select_mode``'s
    depth.
    """
    plan = select_mode(w, m)
    variant = plan.mode.value
    depth = max(plan.recursion, 1) if plan.mode is not Mode.MM1 else 0
    combine_int32 = exact
    if backend == "cuda" and (
            plan.mode is Mode.MM1
            or (plan.mode is Mode.KMM2 and plan.recursion <= 2)):
        variant = "fused"
        combine_int32 = exact or plan.mode is Mode.MM1
    elif backend == "cuda" and plan.mode is Mode.MM2:
        variant = "fused_mm2"
    return ExecPlan(variant=variant, w=w, m=m, backend=backend,
                    block_k=DEFAULT_BLOCK_K, combine_int32=combine_int32,
                    depth=depth)


def _padded(dim: int, block: int) -> int:
    return -(-dim // block) * block


def select_plan(shape: Tuple[int, int, int], w: int, *, m: int = 8,
                backend: str = "cuda", exact: bool = False, table=None,
                context=None) -> ExecPlan:
    """Table-backed execution-plan selection for an (M, K, N) integer GEMM
    (the reference's ``select_plan``).  Each call counts its resolution in
    ``repro_plans_selected_total`` (variant, backend, bucketed shape,
    source) when metrics are enabled.

    ``context`` supplies the backend and, when it carries one, the tuning
    table; under its mesh on ``"cuda"`` the table key and the bounds are
    the per-rank local shape (``tune.space.local_shape``), which the
    sharded kernel runs.  Resolution order:

      1. no table (none passed, none in the context, none installed with
         ``tune.table.set_active_table``) -> the analytic plan;
      2. a table entry for this (backend, bucketed M/K/N, w, m) key -> the
         recorded winner, validated against the search space's bounds
         (``tune.space.validate``); an invalid entry is never run;
      3. no entry -> the cost-model prior's best plan in the analytic
         plan's numerics class (memoized per bucketed key).

    The plan is always numerics-identical to the analytic one (the
    reference's ``pin_numerics``, which every model-facing path sets): the
    winner is taken when its
    :func:`numerics_fingerprint` matches and, for fp32 plans, its padded K
    equals the unclamped analytic plan's; otherwise only its ``block_k``
    (a ``"cuda"`` entry of a kernel variant), under the same padding rule;
    otherwise the analytic plan.
    """
    plan = _select_plan_impl(shape, w, m=m, backend=backend, exact=exact,
                             table=table, context=context)
    if obs_metrics.enabled():
        from repro_torch.tune.space import bucket_shape   # lazy, as below
        _PLANS_SELECTED.inc(plan.variant, plan.backend,
                            "x".join(str(d) for d in bucket_shape(shape)),
                            plan.source)
    return plan


def _select_plan_impl(shape: Tuple[int, int, int], w: int, *, m: int,
                      backend: str, exact: bool, table,
                      context) -> ExecPlan:
    if context is not None:
        backend = context.backend
        if table is None and context.tuning_table is not None:
            table = context.resolve_table()
        if context.mesh is not None and backend == "cuda":
            # the sharded kernel runs on the local block: key the table
            # and check the bounds on the per-rank shape
            shape = context.local_gemm_shape(shape)
    base = analytic_plan(w, m, backend=backend, exact=exact)
    if table is None:
        from repro_torch.tune import table as tune_table   # lazy: core must
        table = tune_table.get_active_table()              # not need tune
    if table is None:
        return base
    from repro_torch.tune import space as tune_space
    entry = table.lookup(backend, shape, w, m)
    source = "table"
    if entry is None:
        entry = _prior_plan_cached(tune_space.bucket_shape(shape), w, m,
                                   backend, exact)
        source = "prior"
    if entry is None:
        return base
    entry = replace(entry, w=w, m=m, backend=backend, source=source)
    if tune_space.validate(entry, shape) is not None:
        return base                      # never run a candidate that fails
    if (numerics_fingerprint(entry) == numerics_fingerprint(base)
            and _k_padding_matches(shape, base, entry)):
        return entry
    if entry.variant not in KERNEL_VARIANTS or entry.backend != "cuda":
        return base          # no kernel tile measured: keep the analytic plan
    if not _k_padding_matches(shape, base,
                              replace(base, block_k=entry.block_k)):
        return base
    return replace(base, block_k=entry.block_k, source=source + "+tiles")


@functools.lru_cache(maxsize=4096)
def _prior_plan_cached(bucket: Tuple[int, int, int], w: int, m: int,
                       backend: str, exact: bool) -> Optional[ExecPlan]:
    """The cost-model prior per bucketed key, memoized: a table miss would
    otherwise rank the whole candidate space on every GEMM call.  The plan
    is re-validated against the real shape in :func:`select_plan`, and it
    does not depend on any table's contents."""
    from repro_torch.tune import space as tune_space
    return tune_space.prior_plan(bucket, w, m=m, backend=backend,
                                 exact=exact)


def _k_padding_matches(shape, base: ExecPlan, entry: ExecPlan) -> bool:
    """An fp32-combine plan's value depends on its padded K: padded
    positions contribute centered digits and the ``z*z*kp`` correction,
    which cancel in real arithmetic but round in fp32.  Bit identity with
    the analytic plan therefore needs the same padded K (against the
    *unclamped* analytic ``block_k``, as the reference compares).  Exact-int
    plans equal the true product for any padding, and the ATen route pads
    nothing."""
    if entry.is_exact_int or entry.backend != "cuda":
        return True
    k = shape[1]
    return _padded(k, base.block_k) == _padded(k, entry.block_k)
