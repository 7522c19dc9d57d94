"""Shard-mapped execution of the integer-GEMM kernels (port of
``repro.dist.shard_gemm``).

Each rank runs the *unchanged* kernel wrapper on its local block.  Layout
(:func:`negotiate`):

  * M (tokens, decode lanes) over the data axes, the axes the serve pool
    and the batch ride (:mod:`repro_torch.dist.sharding`);
  * N (output channels) over ``model``, as the column-TP weight rules put
    ``wi -> ("embed", "mlp")``;
  * K replicated.  Every output element then sees the unsharded kernel's
    full-K digit arithmetic (the same padded K, zero-point correction and
    fp32 rounding), so sharded == unsharded bit for bit: the digit
    accumulators live inside each rank's launch and the correction runs
    there, before any collective.

Where the reference's ``shard_map`` gets its in-specs from XLA, a rank here
assembles its operands itself: its rows of x (or all of them, when the
engine's activations are already this data rank's rows:
``sharding.batch_is_local``), and the weight's and its scales' ``(K, N /
T)`` blocks — from a DTensor at rest, its data-axis (FSDP) rows
all-gathered and its column block kept or cut (:func:`weight_block`),
from a whole tensor its column block cut.  The kernel's output is all-gathered over the spec's axes, so
the next op sees global values (over ``model`` only for batch-local rows).

An explicit K-sharded spec (``GemmShardSpec(k_axes=...)``) runs in
:func:`sharded_run_plan` for exact-int plans only, the int32 partials
summed by an all-reduce; fp32-combine plans are refused, as the reference
refuses them.  :func:`negotiate` never proposes it.

Training's backward (``quant.qmatmul._mesh_ste``, and for the grouped
expert GEMMs ``_mesh_bste``) runs on the same spec as its forward: the
same N block (the same experts) of the weight, gathered again from the
shard by :func:`weight_block`, and :func:`weight_grad` turns the block's
gradient into the gradient of the shard held at rest.  A grouped GEMM's
weight is quantized on this rank's experts alone
(``sharding.map_columns(dim=0)``), so no rank gathers another model
rank's experts.

Fallback contract: where no mesh axis tiles the GEMM (or the *local* shape
fails the kernel's bounds), the caller sends that GEMM to the ATen route.
Each occurrence is counted (``repro_shard_gemm_fallback_total`` and
:func:`fallback_counts`), and logged once per (shape, w, reason).

One difference from the reference: on a mesh of one device every GEMM is
tiled trivially (an empty spec, the whole GEMM local), where the
reference's negotiation finds no axis and sends every GEMM to XLA — which
would make a one-device mesh change the numerics of every GEMM.
"""
from __future__ import annotations

import logging
from dataclasses import replace
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.dispatch import ExecPlan, GemmShardSpec
from repro_torch.dist import collectives as C
from repro_torch.dist import sharding as S
from repro_torch.obs import metrics as obs_metrics

Shape = Tuple[int, int, int]

log = logging.getLogger("repro_torch.dist")

# One log line per (shape, w, reason); every occurrence is counted.
_LOGGED_FALLBACKS: set = set()
_FALLBACK_COUNTS: Dict[Tuple[Shape, int, str], int] = {}
_FALLBACKS = obs_metrics.counter(
    "repro_shard_gemm_fallback_total",
    "sharded cuda GEMMs sent to the ATen route, by shape/w/reason",
    labels=("shape", "w", "reason"))


def local_shape(shape: Shape, spec: GemmShardSpec, mesh) -> Shape:
    """Per-rank (M, K, N) under ``spec`` on ``mesh``."""
    M, K, N = shape
    return (M // S.axes_size(mesh, spec.m_axes),
            K // S.axes_size(mesh, spec.k_axes),
            N // S.axes_size(mesh, spec.n_axes))


def negotiate(shape: Shape, mesh, *, n_experts: Optional[int] = None
              ) -> Tuple[Optional[GemmShardSpec], str]:
    """Mesh axes for an (M, K, N) GEMM, or why none fit.

    ``(spec, "")``, or ``(None, reason)`` where the mesh cannot tile the
    GEMM and the caller falls back to the ATen route.  K is always
    replicated.  A grouped GEMM (``n_experts``) puts the expert dim on
    ``model`` and keeps M and N local per expert.  A one-device mesh
    tiles every GEMM with an empty spec (module docstring)."""
    if mesh is None or getattr(mesh, "empty", False):
        return None, "no mesh"
    if S.mesh_size(mesh) == 1:
        return GemmShardSpec(), ""
    M, K, N = shape
    daxes = S.data_axes(mesh)
    dsize = S.axes_size(mesh, daxes)
    msize = S.mesh_axis_size(mesh, "model")
    if n_experts is not None:
        if msize > 1 and n_experts % msize == 0:
            return GemmShardSpec(e_axes=("model",)), ""
        return None, (f"expert dim {n_experts} not divisible by model "
                      f"axis ({msize})")
    m_axes = daxes if dsize > 1 and M % dsize == 0 else ()
    n_axes = ("model",) if msize > 1 and N % msize == 0 else ()
    if not m_axes and not n_axes:
        return None, (f"no mesh axis tiles ({M}, {K}, {N}): "
                      f"M={M} % data({dsize}) and N={N} % model({msize}) "
                      f"both nonzero")
    return GemmShardSpec(m_axes=m_axes, n_axes=n_axes), ""


def log_fallback(shape: Shape, w: int, reason: str) -> None:
    """Record a GEMM the mesh sends to the ATen route: counted every time,
    logged once per (shape, w, reason)."""
    shape = tuple(int(d) for d in shape)
    key = (shape, w, reason)
    _FALLBACK_COUNTS[key] = _FALLBACK_COUNTS.get(key, 0) + 1
    _FALLBACKS.inc("x".join(str(d) for d in shape), w, reason)
    if key in _LOGGED_FALLBACKS:
        return
    _LOGGED_FALLBACKS.add(key)
    log.info("cuda GEMM %s (w=%d) under mesh falls back to ATen: %s",
             shape, w, reason)


def fallback_counts() -> Dict[Tuple[Shape, int, str], int]:
    """Fallbacks by (shape, w, reason) since the last reset (host-side,
    counted whether metrics are on or off)."""
    return dict(_FALLBACK_COUNTS)


def reset_fallbacks() -> None:
    _FALLBACK_COUNTS.clear()
    _LOGGED_FALLBACKS.clear()


# ---------------------------------------------------------------------------
# Operand blocks.
# ---------------------------------------------------------------------------


def _block(x: torch.Tensor, dim: int, axes, mesh) -> torch.Tensor:
    """This rank's block of a whole ``x`` along ``dim`` over ``axes``."""
    if not axes:
        return x
    idx, n = S.axes_index(mesh, axes)
    size = x.shape[dim] // n
    return x.narrow(dim, idx * size, size)


def weight_block(w, want: Dict[int, Tuple[str, ...]], mesh
                  ) -> torch.Tensor:
    """This rank's block of a weight under ``want`` (tensor dim -> mesh
    axes).  A DTensor at rest is all-gathered over every mesh dim that
    shards it where ``want`` does not (the reference's ``P(None, ns)``
    in-spec: the FSDP rows), and cut where ``want`` shards a dim it holds
    whole; a whole tensor is cut."""
    if S.is_dtensor(w):
        rest = C.dtensor_axes(w)
        keep = {d: ax for d, ax in rest.items() if want.get(d) == ax}
        local = C.gather_dtensor(w, keep)
        for d, axes in want.items():
            if rest.get(d) != axes:
                local = _block(local, d, axes, mesh)
        return local
    for d, axes in want.items():
        w = _block(w, d, axes, mesh)
    return w


def weight_grad(dw: torch.Tensor, w, want: Dict[int, Tuple[str, ...]],
                mesh):
    """The gradient of ``w`` from ``dw``, the gradient of its block
    :func:`weight_block` ``(w, want)`` that this rank formed from its own
    rows (the STE backward's ``x^T @ g`` on its rows and its columns):
    ``dw`` is gathered over the ``want`` axes ``w`` is not held over at
    rest (each model rank formed its own columns), then cut to the block
    ``w`` holds at rest — summed over the data axes it is held over
    (a reduce-scatter: each data rank's part comes from its own rows), cut
    over the others.  Over data axes ``w`` is not held over, the result
    stays this rank's part, summed by the train step once per leaf (or by
    the gather's backward of a weight gathered there, as the tied head's
    table is).  A plain ``w`` is its own block at rest: ``dw`` whole.
    Returns a plain tensor: this rank's block."""
    rest = C.dtensor_axes(w) if S.is_dtensor(w) else {}
    for d, axes in want.items():
        if axes and rest.get(d) != axes:
            dw = C.all_gather(dw, mesh, axes, d)
    daxes = S.data_axes(mesh)
    for d, axes in rest.items():
        if want.get(d) == axes:
            continue
        summed = tuple(a for a in axes if a in daxes)
        if summed == axes:
            dw = C.reduce_scatter(dw, mesh, axes, d)
            continue
        if summed:
            dw = C.all_reduce(dw, mesh, summed)
        dw = _block(dw, d, axes, mesh)
    return dw


def column_block(x: torch.Tensor, axes, mesh) -> torch.Tensor:
    """This rank's block of the last dim of ``x`` over ``axes`` (a GEMM's
    N block under its spec's ``n_axes``)."""
    return _block(x, x.dim() - 1, axes, mesh)


def expert_block(x: torch.Tensor, axes, mesh) -> torch.Tensor:
    """This rank's experts of a whole expert-major ``x`` over ``axes`` (a
    grouped GEMM's block under its spec's ``e_axes``)."""
    return _block(x, 0, axes, mesh)


# ---------------------------------------------------------------------------
# Shard-mapped wrappers.
# ---------------------------------------------------------------------------


def shard_dense_gemm(fn: Callable, mesh, spec: GemmShardSpec, *,
                     rows_local: bool = False) -> Callable:
    """``fn(qx, qw, sx, sw) -> out`` on (M, K) x (K, N) with (M, 1) and
    (1, N) scales, run on each rank's block.  The returned callable takes
    the global operands (``qw`` whole or a DTensor at rest) and returns the
    global (M, N) output; with ``rows_local`` ``qx``/``sx`` are already
    this data rank's rows and the output keeps them.  K must be replicated
    (fp32 bit identity; :func:`sharded_run_plan` runs exact-int split-K)."""
    if spec.k_axes:
        raise ValueError("dense dequant GEMM requires replicated K "
                         "(fp32 bit-identity); got k_axes=%r" % (spec.k_axes,))
    m_cut = () if rows_local else spec.m_axes

    def run(qx, qw, sx, sw):
        qxl = _block(qx, 0, m_cut, mesh)
        sxl = _block(sx, 0, m_cut, mesh)
        qwl = weight_block(qw, {1: spec.n_axes}, mesh)
        swl = weight_block(sw, {1: spec.n_axes}, mesh)
        out = fn(qxl.contiguous(), qwl.contiguous(), sxl.contiguous(),
                 swl.contiguous())
        out = C.all_gather(out, mesh, spec.n_axes, 1)
        return C.all_gather(out, mesh, m_cut, 0)

    return run


def shard_grouped_gemm(fn: Callable, mesh, spec: GemmShardSpec,
                       counts: Optional[torch.Tensor] = None,
                       want: Optional[dict] = None) -> Callable:
    """``fn(qx, qw, sx, sw[, counts]) -> out`` on (E, C, K) x (E, K, N)
    with (E, C, 1) / (E, 1, N) scales, each rank launching the grouped
    kernel over its local experts (``spec.e_axes``).  ``counts`` (E, S),
    the ragged live rows, is cut over the same experts and passed as a
    fifth operand, so each rank sees exactly its experts' counts.  The
    returned callable takes the global ``(qx, qw, sx, sw)`` — the weight's
    codes and scales whole, or DTensors at rest (a record's FSDP rows
    gathered) or quantized on this rank's experts
    (``sharding.map_columns(dim=0)``, taken as they are) — and returns
    the global (E, C, N) output.  It writes the block of W it multiplied
    into ``want`` (``{0: e_axes}``), for the STE backward to gather
    again."""
    es = spec.e_axes
    if want is not None:
        want[0] = es

    def run(qx, qw, sx, sw):
        args = [_block(qx, 0, es, mesh), weight_block(qw, {0: es}, mesh),
                _block(sx, 0, es, mesh), weight_block(sw, {0: es}, mesh)]
        if counts is not None:
            args.append(_block(counts, 0, es, mesh))
        out = fn(*[a.contiguous() for a in args])
        return C.all_gather(out, mesh, es, 0)

    return run


def sharded_run_plan(a: torch.Tensor, b, *, plan: ExecPlan, mesh,
                     use_ref_kernels: bool = False) -> torch.Tensor:
    """:func:`repro_torch.kernels.ops.run_plan` on (M, K) x (K, N), sharded.

    Takes ``plan.shard`` where set, else negotiates M/N axes.  Covers the
    fused kernel and the staged variants alike: whatever the plan routes
    to runs on each rank's block.  A K-sharded spec runs as int32 partial
    products summed by an all-reduce over the K axes — exact-int plans
    only: the integer partials sum to the true product."""
    from repro_torch.kernels import ops   # ops -> shard_gemm (its mesh seam)

    spec = plan.shard
    if spec is None:
        spec, reason = negotiate((a.shape[0], a.shape[1], b.shape[1]), mesh)
        if spec is None:
            raise ValueError(f"cannot shard GEMM on mesh {mesh}: {reason}")
    local_plan = replace(plan, shard=None)
    if spec.k_axes and not local_plan.is_exact_int:
        raise ValueError(
            "K-sharded execution is exact-int only (fp32 partial sums "
            f"change rounding); plan {local_plan.variant!r} is fp32-combine")
    al = _block(_block(a, 0, spec.m_axes, mesh), 1, spec.k_axes, mesh)
    bl = weight_block(b, {0: spec.k_axes, 1: spec.n_axes}, mesh)
    out = ops.run_plan(al.contiguous(), bl.contiguous(), plan=local_plan,
                       use_ref_kernels=use_ref_kernels)
    if spec.k_axes:
        out = C.all_reduce(out, mesh, spec.k_axes, dist.ReduceOp.SUM)
    out = C.all_gather(out, mesh, spec.n_axes, 1)
    return C.all_gather(out, mesh, spec.m_axes, 0)


def plan_local_bounds_ok(plan: ExecPlan, lshape: Shape, w: int,
                         m: int) -> Tuple[bool, str]:
    """The kernel's correctness bounds on the per-rank LOCAL shape: the
    unsharded checks of ``quant.qmatmul`` on the local K (the same K while
    negotiation replicates it; explicit for K-sharded callers), and for
    the Strassen variants the full ``tune.space.validate`` on the local
    block.  The reference's per-shard VMEM budget is the TPU's and has no
    counterpart here: the CUDA kernels pick their own tiles."""
    from repro_torch.core.kmm import max_exact_k, plan_accum_k_bound
    from repro_torch.core.strassen import STRASSEN_VARIANTS
    from repro_torch.tune import space as tune_space

    _, k_local, _ = lshape
    if plan.variant in STRASSEN_VARIANTS:
        reason = tune_space.validate(plan, lshape)
        if reason is not None:
            return False, f"strassen bounds on local shape {lshape}: {reason}"
        return True, ""
    if plan.is_exact_int and max_exact_k(w) < k_local:
        return False, (f"local K={k_local} > max_exact_k({w})="
                       f"{max_exact_k(w)}")
    kp = -(-k_local // plan.block_k) * plan.block_k
    bound = plan_accum_k_bound(plan)
    if bound is not None and kp > bound:
        return False, (f"local padded K={kp} > accum bound {bound} for "
                       f"{plan.variant!r} depth={plan.depth} (w={w})")
    return True, ""
