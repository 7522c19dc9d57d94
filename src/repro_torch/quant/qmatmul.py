"""Quantized matmul on the integer GEMM, forward only (port of
``repro.quant.qmatmul``).

Dynamic per-token activation quantization and per-channel weight
quantization to ``w`` bits, then the integer GEMM and the dequant.  Two
entry points, as in the reference: ``quantized_matmul`` for (..., K) @
(K, N) dense layers and ``quantized_matmul_batched`` for (E, C, K) @
(E, K, N) expert GEMMs (ragged with ``counts``/``seg``: dead rows exact
zeros, see ``kernels.fused_gemm.ragged_row_mask``).

Routing follows the reference's ``_quant_gemm``.  On backend ``"cuda"``
with ``force_mode="auto"`` the plan comes from
:func:`repro_torch.core.dispatch.select_plan`.  With no tuning table
installed it is the analytic one with its ``block_k`` clamped to the shape
(``_shrink_tiles``: the clamped ``block_k`` fixes the padded K that the
fp32 combine rounds with), and the GEMM is one launch of the fused kernel
(MM1 for w <= 8, KMM2 for 9-14, MM2 for 15-16, depth-2 KMM for 17-26) with
the dequant epilogue in the kernel; batched GEMMs are one grouped launch.
Under a table the plan is the table's (or the cost prior's) within the
analytic plan's numerics class, unclamped as the reference leaves it; a
staged or Strassen plan runs through ``kernels.ops.run_plan`` and the
dequant ``acc * (sx * sw)`` follows — one expert at a time for batched
GEMMs — bit-identical to the fused epilogue, so a table never moves a
token.  A GEMM the fused kernel cannot take (w >= 27, whose digits need
three KMM levels; a shape past its int32 bounds) takes the ATen route, the
reference's ``"xla_fallback"``.  On backend ``"aten"``, and under
``force_mode="mm2"`` (the paper's MM2 baseline), every GEMM takes the ATen
route: :func:`_int_dot`, the reference's ``_int_dot`` — ``kmm_n`` /
``mm_n`` of :mod:`repro_torch.core.kmm` on the raw digits of the unpadded
int32 codes, fp32 combine — then ``acc * (sx * sw)``.  The route does no
host sync, so a decode graph captures it.  Every GEMM counts its route
(:func:`gemm_routes`, the reference's ``_GEMM_ROUTES``).

Under a mesh (the context's, or for model GEMMs the ambient one,
:func:`repro_torch.dist.sharding.use_mesh`) a ``"cuda"`` GEMM runs
shard-mapped (:func:`_sharded_cuda`, the reference's ``_sharded_pallas``):
M over the data axes, N over ``model``, K replicated, the unchanged kernel
on each rank's block, bit-identical to the unsharded GEMM; a GEMM the mesh
cannot tile, or whose local shape fails the bounds, takes the ATen route,
logged once and counted (``dist.shard_gemm.fallback_counts``).  A weight
held as a DTensor shard (``dist.sharding.shard_params``) is gathered only
as far as it is needed: its FSDP rows for the sharded GEMM and for the
per-call quantizer, which then quantizes this rank's output channels
alone; whole for the ATen route.

Pre-quantized weights (``{"q", "scale"}`` records from
:func:`repro_torch.quant.prequant.prequantize`) take
:func:`prequant_matmul`: only x is quantized, and the record's codes and
scale go to the same GEMM uncopied on the fused route (cast only where the
kernel's carrier is wider than the storage: int16 -> int32 above w = 16).

Training (the reference's ``custom_vjp`` cores): where autograd records
(grad enabled and x or W requiring grad), the two entry points run through
three ``torch.autograd.Function`` classes — dense, batched and ragged — whose
forward is the quantize-then-GEMM above, unchanged (on CUDA the kernels),
and whose backward is the straight-through estimator: ``dx = g @ W^T`` and
``dw = x^T @ g`` in fp32 ATen matmuls on the saved unquantized x and W,
cast to their dtypes (the ragged core masks g to the live rows first and
gives ``counts`` no gradient).  ``round`` has a zero derivative, so the
quantizer must not be differentiated through: the Functions are the
gradient on every device.  Elsewhere (serving, under ``no_grad`` or
``inference_mode``) the GEMM runs without them.  :func:`prequant_matmul`
stays inference only.  Under a training mesh the dense core's backward
runs on blocks (:func:`_mesh_ste`): ``dx`` from this rank's N block of W,
all-reduced over ``model``; ``dW`` of that block from this rank's rows,
reduce-scattered over the data axes to W's FSDP rows.  The batched cores
(MoE) run expert-parallel (:func:`_mesh_bste`): where the grouped GEMM's
experts ride ``model``, each rank quantizes, multiplies and
differentiates its own experts' block alone — ``dx`` of its experts
all-gathered over ``model``, ``dW`` of its experts from its rows
reduce-scattered over the data axes to the FSDP rows held at rest; no
rank gathers another model rank's experts, forward or backward.  The
unquantized matmuls take W whole through
:func:`repro_torch.dist.sharding.full_leaf`, whose gather is
differentiable.
"""
from __future__ import annotations

import math
from dataclasses import replace
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.context import ExecContext
from repro_torch.core.dispatch import ExecPlan, analytic_plan, select_plan
from repro_torch.core.kmm import (default_mm1, kmm_n, max_exact_k, mm_n,
                                  plan_accum_k_bound)
from repro_torch.dist import collectives as dist_coll
from repro_torch.dist import shard_gemm
from repro_torch.dist import sharding as dist_sharding
from repro_torch.kernels import check_grad_fn, ops, records_grad
from repro_torch.kernels.fused_gemm import (fused_gemm, fused_gemm_grouped,
                                            ragged_row_mask)
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.quant.quantize import carrier_dtype, quantize_symmetric
from repro_torch.tune.table import get_active_table

# Quantized GEMMs by (backend, route): "cuda" (the kernels), "aten_fallback"
# (a "cuda" GEMM the kernels cannot take) and "aten".  Host-side: a decode
# graph's GEMMs count at its capture, never at a replay.  Counted whether
# metrics are on or off (launch gates read it).
_GEMM_ROUTES: Dict[Tuple[str, str], int] = {}
# The same counts as the reference's registry instrument, under its name.
_GEMM_ROUTES_TOTAL = obs_metrics.counter(
    "repro_quant_gemm_routes_total",
    "quantized-GEMM dispatch outcomes by backend and route (backend cuda | "
    "aten; route cuda: the hand-written kernels, aten_fallback: a cuda GEMM "
    "the kernels cannot take, aten: the ATen digit recursion); host-side, "
    "so a decode graph's GEMMs count at capture, never at replay",
    labels=("backend", "route"))
# Reasons the kernels declined a "cuda" GEMM (it then took the ATen route).
_PALLAS_FALLBACKS = obs_metrics.counter(
    "repro_pallas_fallback_total",
    "cuda-route declines by reason (outside_fused_window: w needs three KMM "
    "levels; kernel_bounds: the shape exceeds the kernels' int32 bounds), "
    "the GEMM fell back to the ATen route; counted at capture, never at a "
    "decode graph's replay",
    labels=("reason",))


def gemm_routes() -> Dict[Tuple[str, str], int]:
    """Quantized GEMMs by (backend, route) since the last reset."""
    return dict(_GEMM_ROUTES)


def reset_gemm_routes() -> None:
    _GEMM_ROUTES.clear()


def _count_route(backend: str, route: str) -> None:
    key = (backend, route)
    _GEMM_ROUTES[key] = _GEMM_ROUTES.get(key, 0) + 1
    _GEMM_ROUTES_TOTAL.inc(backend, route)


def _quantize(x: torch.Tensor, w: int, axis, carrier
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric w-bit quantization along ``axis`` with keepdims, stored
    straight in the kernel's carrier dtype."""
    return quantize_symmetric(x, w, axis=axis, keepdims=True,
                              storage_dtype=carrier)


def _pow2_cover(n: int, lo: int = 8) -> int:
    v = lo
    while v < n:
        v *= 2
    return v


def _shrink_tiles(plan: ExecPlan, shape) -> ExecPlan:
    """Clamp the analytic K tile to the shape (pow2 cover, floor 8): it
    fixes the fp32 plan's padded K as a pure function of K, exactly as the
    reference's clamp does (its M/N clamps never move a value)."""
    return replace(plan, block_k=min(plan.block_k, _pow2_cover(shape[1])))


def _table(context: Optional[ExecContext]):
    return context.resolve_table() if context is not None else None


def _fused_plan_for(shape, w: int, m: int,
                    context: Optional[ExecContext] = None
                    ) -> Optional[ExecPlan]:
    """The plan for an (M, K, N) GEMM, or None when the shape exceeds the
    kernels' exactness bounds.  Without a table: the analytic plan with
    its K tile clamped.  Under the context's or the active table: the
    plan ``select_plan`` resolves, clamped only when it is the analytic one
    (as the reference does), memoized on the table per (M, K, N, w, m)."""
    table = _table(context)
    if table is None:
        table = get_active_table()
    if table is None:
        return _checked(_shrink_tiles(analytic_plan(w, m, backend="cuda"),
                                      shape), shape[1])
    key = (tuple(shape), w, m)
    if key not in table.plans:
        plan = select_plan(shape, w, m=m, backend="cuda", table=table)
        if plan.source == "analytic":
            plan = _shrink_tiles(plan, shape)
        table.plans[key] = _checked(plan, shape[1])
    return table.plans[key]


def _checked(plan: ExecPlan, k_dim: int) -> Optional[ExecPlan]:
    """``plan``, or None outside its int32 headroom or digit-accumulator
    bound (then the ATen route takes the GEMM)."""
    if plan.is_exact_int and max_exact_k(plan.w) < k_dim:
        return None
    kp = -(-k_dim // plan.block_k) * plan.block_k
    bound = plan_accum_k_bound(plan)
    if bound is not None and kp > bound:
        return None
    return plan


def _fused_mode(plan: ExecPlan) -> str:
    if plan.variant == "fused_mm2":
        return "mm2"
    return "kmm4" if plan.depth == 2 else "auto"


def _fused_cuda(qx, qw, sx, sw, w: int, m: int, out_dtype,
                counts: Optional[torch.Tensor] = None,
                seg: Optional[int] = None,
                context: Optional[ExecContext] = None,
                want: Optional[dict] = None) -> Optional[torch.Tensor]:
    """The GEMM + dequant: dense (..., K) x (K, N), or batched (E, C, K) x
    (E, K, N), on the resolved plan (:func:`run_plan_dequant`).  Returns
    None where the reference takes its XLA route: w outside the fused
    windows, or the shape past the kernel's bounds.  ``want``: see
    :func:`_sharded_cuda`."""
    batched = qw.dim() == 3
    if batched:
        _, m_dim, k_dim = qx.shape
        n_dim = qw.shape[2]
    else:
        k_dim = qx.shape[-1]
        n_dim = qw.shape[1]
        m_dim = math.prod(qx.shape[:-1])
    if analytic_plan(w, m, backend="cuda").variant \
            not in ("fused", "fused_mm2"):
        _PALLAS_FALLBACKS.inc("outside_fused_window")
        return None                     # recursion deeper than 2 levels
    if context is not None and context.mesh is not None:
        return _sharded_cuda(qx, qw, sx, sw, w, m, out_dtype, counts, seg,
                             context, (m_dim, k_dim, n_dim), want)
    plan = _fused_plan_for((m_dim, k_dim, n_dim), w, m, context)
    if plan is None:
        _PALLAS_FALLBACKS.inc("kernel_bounds")
        return None
    return run_plan_dequant(qx, qw, sx, sw, plan, out_dtype, counts, seg)


def _sharded_cuda(qx, qw, sx, sw, w: int, m: int, out_dtype,
                  counts: Optional[torch.Tensor], seg: Optional[int],
                  context: ExecContext, dims,
                  want: Optional[dict] = None) -> Optional[torch.Tensor]:
    """The GEMM + dequant shard-mapped over ``context.mesh`` (the
    reference's ``_sharded_pallas``): each rank runs the unchanged kernel on
    its block (:mod:`repro_torch.dist.shard_gemm`), the plan resolved and
    its bounds checked on the local shape.  With K replicated no collective
    touches the accumulators, so the output equals the unsharded one bit
    for bit.  Returns None — the ATen route, logged and counted — where the
    mesh tiles no dim of the GEMM or the local shape fails the bounds.
    Under a batch-local ambient mesh (the engine) x holds this data rank's
    rows, and the global M is D times its rows.  A GEMM that runs
    shard-mapped writes the block of W it multiplied into ``want``, as
    ``shard_gemm.weight_block`` reads it (dense ``{1: n_axes}``, grouped
    ``{0: e_axes}``): the STE backward gathers that block again."""
    mesh = context.mesh
    batched = qw.dim() == 3
    _, k_dim, n_dim = dims
    rows_local = not batched and dist_sharding.batch_is_local(mesh)
    shape, spec, plan, reason = _shard_spec(
        dims, w, m, context, qx.shape[0] if batched else None)
    if spec is None:
        shard_gemm.log_fallback(shape, w, reason)
        return None
    if batched:
        def local_grouped(qxl, qwl, sxl, swl, *cnt):
            return run_plan_dequant(qxl, qwl, sxl, swl, plan, out_dtype,
                                    cnt[0] if cnt else None, seg)
        return shard_gemm.shard_grouped_gemm(local_grouped, mesh, spec,
                                             counts, want)(qx, qw, sx, sw)

    def local_dense(qxl, qwl, sxl, swl):
        return run_plan_dequant(qxl, qwl, sxl, swl, plan, out_dtype)

    if want is not None:
        want[1] = spec.n_axes

    rows = qx.reshape(-1, k_dim)
    if not dist_sharding.is_dtensor(sw):
        sw = sw.reshape(1, n_dim)
    out = shard_gemm.shard_dense_gemm(local_dense, mesh, spec,
                                      rows_local=rows_local)(
        rows, qw, sx.reshape(rows.shape[0], 1), sw)
    return out.reshape(qx.shape[:-1] + (n_dim,))


def _shard_spec(dims, w: int, m: int, context: ExecContext,
                n_experts: Optional[int] = None):
    """How :func:`_sharded_cuda` runs an (M, K, N) GEMM on
    ``context.mesh``: (global shape, spec, the plan on the local shape,
    "") where it runs shard-mapped, (global shape, None, None, why not)
    where it takes the ATen route.  Under a batch-local ambient mesh the
    global M is D times the rows given."""
    mesh = context.mesh
    m_dim, k_dim, n_dim = dims
    if n_experts is None and dist_sharding.batch_is_local(mesh):
        m_dim *= dist_sharding.data_size(mesh)
    shape = (m_dim, k_dim, n_dim)
    spec, reason = shard_gemm.negotiate(shape, mesh, n_experts=n_experts)
    if spec is None:
        return shape, None, None, reason
    lshape = shard_gemm.local_shape(shape, spec, mesh)
    plan = _fused_plan_for(lshape, w, m, context)
    if plan is None:
        return shape, None, None, "local-K kernel bounds failed"
    ok, reason = shard_gemm.plan_local_bounds_ok(plan, lshape, w, m)
    if not ok:
        return shape, None, None, reason
    return shape, spec, plan, ""


def run_plan_dequant(qx, qw, sx, sw, plan: ExecPlan, out_dtype,
                     counts: Optional[torch.Tensor] = None,
                     seg: Optional[int] = None) -> torch.Tensor:
    """One resolved plan on quantized codes, dequantized to ``out_dtype``:
    the GEMM the quantized matmul runs, and what the autotuner times.  A
    fused plan is one launch (grouped for batched GEMMs) with the dequant
    epilogue in the kernel; a staged plan runs through ``ops.run_plan`` —
    per expert for batched GEMMs, dead rows then zeroed — and the dequant
    ``acc * (sx * sw)`` follows in the fused epilogue's fp32 order.

    With tracing enabled a fused plan records the ``run_plan`` span the
    staged plans record in ``ops.run_plan`` (the same attributes; ``shape``
    per expert and ``experts`` for a grouped launch): a launch time on
    CUDA, opened once at a decode graph's capture."""
    if plan.variant not in ("fused", "fused_mm2"):
        return _staged_dequant(qx, qw, sx, sw, plan, out_dtype, counts, seg)
    if not obs_trace.enabled():
        return _fused_dequant(qx, qw, sx, sw, plan, out_dtype, counts, seg)
    grouped = qw.dim() == 3
    m_dim = qx.shape[1] if grouped else math.prod(qx.shape[:-1])
    attrs = dict(variant=plan.variant, w=plan.w, backend=plan.backend,
                 depth=plan.depth,
                 shape=f"{m_dim}x{qx.shape[-1]}x{qw.shape[-1]}")
    if grouped:
        attrs["experts"] = qw.shape[0]
    with obs_trace.span("run_plan", **attrs):
        return _fused_dequant(qx, qw, sx, sw, plan, out_dtype, counts, seg)


def _fused_dequant(qx, qw, sx, sw, plan: ExecPlan, out_dtype,
                   counts: Optional[torch.Tensor], seg: Optional[int]
                   ) -> torch.Tensor:
    kw = dict(w=plan.w, m=plan.m, mode=_fused_mode(plan),
              block_k=plan.block_k, combine_int32=plan.combine_int32,
              out_dtype=out_dtype)
    if qw.dim() == 3:
        return fused_gemm_grouped(qx.contiguous(), qw.contiguous(),
                                  sx.contiguous(), sw.contiguous(), counts,
                                  seg=seg, **kw)
    k_dim, n_dim = qw.shape
    m_dim = math.prod(qx.shape[:-1])
    out = fused_gemm(qx.reshape(m_dim, k_dim).contiguous(), qw.contiguous(),
                     sx.reshape(m_dim, 1), sw.reshape(1, n_dim), **kw)
    return out.reshape(qx.shape[:-1] + (n_dim,))


def _staged_dequant(qx, qw, sx, sw, plan: ExecPlan, out_dtype,
                    counts: Optional[torch.Tensor], seg: Optional[int]
                    ) -> torch.Tensor:
    f32 = torch.float32
    if qw.dim() == 2:
        k_dim, n_dim = qw.shape
        acc = ops.run_plan(qx.reshape(-1, k_dim), qw, plan=plan)
        out = acc.to(f32) * (sx.reshape(-1, 1) * sw.reshape(1, n_dim))
        return out.to(out_dtype).reshape(qx.shape[:-1] + (n_dim,))
    acc = torch.stack([ops.run_plan(qx[e], qw[e], plan=plan)
                       for e in range(qx.shape[0])])
    out = (acc.to(f32) * (sx * sw)).to(out_dtype)
    if counts is not None:
        out = torch.where(ragged_row_mask(counts, seg, out.shape[1]), out,
                          torch.zeros_like(out))
    return out


def _dot_shape(qx: torch.Tensor, qw: torch.Tensor, dims
               ) -> Tuple[int, int, int]:
    """Flattened (M, K, N) of a dot_general (batch dims folded into M)."""
    (lc, rc), (lb, rb) = dims
    k = math.prod(qx.shape[a] for a in lc)
    mm = math.prod(qx.shape[a] for a in range(qx.dim()) if a not in lc)
    n = math.prod(qw.shape[a] for a in range(qw.dim())
                  if a not in rc and a not in rb)
    return mm, k, n


def _int_dot(qx: torch.Tensor, qw: torch.Tensor, w: int, m: int, dims,
             force_mode: str = "auto", table=None) -> torch.Tensor:
    """The ATen route's integer GEMM on quantized codes, fp32 out (the
    reference's ``_int_dot``).  The plan is ``select_plan``'s on backend
    ``"aten"``, numerics-pinned: a table cannot move a bit here.  Exact
    class: the exact int32 product; fp32 class: the paper's KMM2 / MM2 digit
    recursion at the plan's digits, fp32 combine; ``force_mode="mm2"``:
    ``mm_n`` above the MM1 window."""
    qx, qw = qx.to(torch.int32), qw.to(torch.int32)
    eplan = select_plan(_dot_shape(qx, qw, dims), w, m=m, backend="aten",
                        table=table)
    f32 = torch.float32
    if force_mode == "mm2" and w > m:
        return mm_n(qx, qw, w=w, n=max(eplan.digits, 2),
                    dimension_numbers=dims, combine_dtype=f32)
    if eplan.is_exact_int:
        return default_mm1()(qx, qw, dims, bits=w).to(f32)
    fn = kmm_n if eplan.variant == "kmm2" else mm_n
    return fn(qx, qw, w=w, n=max(eplan.digits, 2), dimension_numbers=dims,
              combine_dtype=f32)


def _quant_gemm(qx, qw, sx, sw, w: int, m: int, out_dtype,
                context: Optional[ExecContext],
                counts: Optional[torch.Tensor] = None,
                seg: Optional[int] = None,
                want: Optional[dict] = None) -> torch.Tensor:
    """Dequantized GEMM, routed as the reference routes it: the kernels on
    ``"cuda"`` with ``force_mode="auto"`` where they can take the GEMM,
    else the ATen route (:func:`_int_dot`), whose output takes the ragged
    mask.  Every GEMM counts its route.  ``want``: see
    :func:`_sharded_cuda` (left empty where the GEMM takes W whole)."""
    ctx = context if context is not None else ExecContext()
    if ctx.backend == "cuda" and ctx.force_mode == "auto":
        out = _fused_cuda(qx, qw, sx, sw, w, m, out_dtype, counts, seg,
                          context=ctx, want=want)
        if out is not None:
            _count_route("cuda", "cuda")
            return out
        _count_route("cuda", "aten_fallback")
    else:
        _count_route(ctx.backend, "aten")
    # the ATen route takes W whole
    qw, sw = dist_sharding.full_leaf(qw), dist_sharding.full_leaf(sw)
    dims = (((2,), (1,)), ((0,), (0,))) if qw.dim() == 3 \
        else (((qx.dim() - 1,), (0,)), ((), ()))
    acc = _int_dot(qx, qw, w, m, dims, ctx.force_mode, _table(ctx))
    out = (acc * (sx * sw)).to(out_dtype)
    if counts is not None:
        out = torch.where(ragged_row_mask(counts, seg, out.shape[1]), out,
                          torch.zeros_like(out))
    return out


def _qmm_forward(x, wmat, w_bits, m, context, want=None):
    carrier = carrier_dtype(w_bits, m)
    qx, sx = _quantize(x, w_bits, -1, carrier)        # per token
    # per output channel; a weight sharded at rest on its K rows gathered,
    # on this rank's channels alone
    qw, sw = dist_sharding.map_columns(
        wmat, lambda wl: _quantize(wl, w_bits, 0, carrier))
    return _quant_gemm(qx, qw, sx, sw, w_bits, m, x.dtype, context,
                       want=want)


def _qbmm_forward(x, wmat, w_bits, m, context, counts=None, seg=None,
                  want=None):
    """The grouped GEMM's quantize-then-GEMM.  W is quantized per (expert,
    output channel), so where its experts are held over ``model`` each
    rank quantizes its own experts' block alone (their FSDP rows gathered,
    never another model rank's experts), which the expert-parallel GEMM
    takes as it is: its codes and scales are the whole tensor's, bit for
    bit.  ``want``: see :func:`_sharded_cuda`."""
    carrier = carrier_dtype(w_bits, m)
    qx, sx = _quantize(x, w_bits, -1, carrier)        # per (expert, row)
    qw, sw = dist_sharding.map_columns(
        wmat, lambda wl: _quantize(wl, w_bits, 1, carrier), dim=0)
    return _quant_gemm(qx, qw, sx, sw, w_bits, m, x.dtype, context, counts,
                       seg, want)


# ---------------------------------------------------------------------------
# Straight-through backward: the reference's three custom_vjp cores.
# ---------------------------------------------------------------------------


def _mesh_ste(ctx, g, x, wmat, mesh):
    """The dense STE backward on blocks (the reference's ``_qmm_bwd``, which
    GSPMD partitions): with ``n`` the N block the forward ran (``ctx.want``,
    written by the forward's routing) and W's block gathered again from the
    saved shard, ``dx = g[:, n] @ W[:, n]^T`` all-reduced over the block's
    axes, and ``dW[:, n] = x^T @ g[:, n]`` on this rank's rows, cut to W's
    block at rest by
    ``shard_gemm.weight_grad``.  ``g`` is the whole gradient of the
    gathered output, the same on every model rank.  Products in fp32, as
    unsharded (on a mesh of one it is the unsharded backward, op for op)."""
    f32 = torch.float32
    cols = ctx.want.get(1, ())
    gc = shard_gemm.column_block(g.to(f32), cols, mesh)
    dx = dw = None
    if ctx.needs_input_grad[0]:
        wblk = shard_gemm.weight_block(wmat, ctx.want, mesh)
        dx = torch.matmul(gc, wblk.to(f32).T)
        dx = dist_coll.all_reduce(dx, mesh, cols).to(x.dtype)
    if ctx.needs_input_grad[1]:
        x2 = x.reshape(-1, x.shape[-1]).to(f32)
        dw = x2.T @ gc.reshape(-1, gc.shape[-1])
        dw = shard_gemm.weight_grad(dw, wmat, ctx.want, mesh)
        dw = dist_sharding.like(wmat, dw.to(wmat.dtype))
    return dx, dw


class _QmmCore(torch.autograd.Function):
    """Dense core: (..., K) @ (K, N); the reference's ``_qmm_core``.  Under
    a mesh (the ambient one, as training runs it) its backward runs on
    blocks (:func:`_mesh_ste`); it saves W's shard, never the gathered
    weight."""

    @staticmethod
    def forward(ctx, x, wmat, w_bits, m, context):
        ctx.save_for_backward(x, wmat)
        ctx.mesh = dist_sharding.current_mesh()
        ctx.want = {}
        return _qmm_forward(x, wmat, w_bits, m, context, ctx.want)

    @staticmethod
    def backward(ctx, g):
        x, wmat = ctx.saved_tensors
        if ctx.mesh is not None:
            return _mesh_ste(ctx, g, x, wmat, ctx.mesh) + (None,) * 3
        f32 = torch.float32
        gf = g.to(f32)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.matmul(gf, wmat.to(f32).T).to(x.dtype)
        if ctx.needs_input_grad[1]:
            x2 = x.reshape(-1, x.shape[-1]).to(f32)
            dw = (x2.T @ gf.reshape(-1, gf.shape[-1])).to(wmat.dtype)
        return dx, dw, None, None, None


def _live_rows(g, counts, seg: int) -> torch.Tensor:
    """``g`` in fp32 with the ragged dead rows zeroed (``counts`` None:
    every row live)."""
    gf = g.to(torch.float32)
    if counts is None:
        return gf
    return torch.where(ragged_row_mask(counts, seg, g.shape[1]), gf,
                       torch.zeros((), dtype=torch.float32, device=g.device))


def _batched_ste(ctx, x, wmat, gf):
    f32 = torch.float32
    dx = dw = None
    if ctx.needs_input_grad[0]:
        dx = torch.bmm(gf, wmat.to(f32).transpose(1, 2)).to(x.dtype)
    if ctx.needs_input_grad[1]:
        dw = torch.bmm(x.to(f32).transpose(1, 2), gf).to(wmat.dtype)
    return dx, dw


def _mesh_bste(ctx, g, x, wmat, mesh, counts=None):
    """The grouped STE backward on blocks (the reference's ``_qbmm_bwd``,
    which GSPMD partitions), :func:`_mesh_ste`'s counterpart: with ``e``
    the experts the forward ran on this rank (``ctx.want``, written by the
    forward's routing; none where the GEMM took W whole) and W's block
    gathered again from the saved shard, ``dx[e] = g[e] @ W[e]^T``
    all-gathered over the expert axes (each model rank owns whole
    experts), and ``dW[e] = x[e]^T @ g[e]`` on this rank's rows, cut to
    W's block at rest by ``shard_gemm.weight_grad`` (a reduce-scatter over
    the data axes the experts' rows are held over).  ``g`` is the whole
    gradient of the gathered output, the same on every model rank; the
    ragged mask takes the block's ``counts`` first.  Products in fp32, as
    unsharded (on a mesh of one it is the unsharded backward, op for
    op)."""
    f32 = torch.float32
    es = ctx.want.get(0, ())
    if counts is not None:
        counts = shard_gemm.expert_block(counts, es, mesh)
    gf = _live_rows(shard_gemm.expert_block(g, es, mesh), counts, ctx.seg)
    dx = dw = None
    if ctx.needs_input_grad[0]:
        wblk = shard_gemm.weight_block(wmat, {0: es}, mesh)
        dx = torch.bmm(gf, wblk.to(f32).transpose(1, 2)).to(x.dtype)
        dx = dist_coll.all_gather(dx, mesh, es, 0)
    if ctx.needs_input_grad[1]:
        xb = shard_gemm.expert_block(x, es, mesh)
        dw = torch.bmm(xb.to(f32).transpose(1, 2), gf)
        dw = shard_gemm.weight_grad(dw, wmat, {0: es}, mesh)
        dw = dist_sharding.like(wmat, dw.to(wmat.dtype))
    return dx, dw


class _QbmmCore(torch.autograd.Function):
    """Batched core: (E, C, K) @ (E, K, N); the reference's
    ``_qbmm_core``.  Under a mesh its backward runs on blocks
    (:func:`_mesh_bste`); it saves W's shard, never the gathered
    experts."""

    @staticmethod
    def forward(ctx, x, wmat, w_bits, m, context):
        ctx.save_for_backward(x, wmat)
        ctx.mesh = dist_sharding.current_mesh()
        ctx.want, ctx.seg = {}, None
        return _qbmm_forward(x, wmat, w_bits, m, context, want=ctx.want)

    @staticmethod
    def backward(ctx, g):
        x, wmat = ctx.saved_tensors
        if ctx.mesh is not None:
            return _mesh_bste(ctx, g, x, wmat, ctx.mesh) + (None,) * 3
        return _batched_ste(ctx, x, wmat, g.to(torch.float32)) + (
            None, None, None)


class _QbmmRaggedCore(torch.autograd.Function):
    """Ragged batched core, the reference's ``_qbmm_ragged_core``: dead
    rows of the forward output are exact zeros, so their cotangents are
    masked out before the STE products; ``counts`` gets no gradient.  Under
    a mesh as :class:`_QbmmCore`."""

    @staticmethod
    def forward(ctx, x, wmat, counts, w_bits, m, seg, context):
        ctx.save_for_backward(x, wmat, counts)
        ctx.seg = seg
        ctx.mesh = dist_sharding.current_mesh()
        ctx.want = {}
        return _qbmm_forward(x, wmat, w_bits, m, context, counts, seg,
                             ctx.want)

    @staticmethod
    def backward(ctx, g):
        x, wmat, counts = ctx.saved_tensors
        if ctx.mesh is not None:
            return _mesh_bste(ctx, g, x, wmat, ctx.mesh, counts) + \
                (None,) * 5
        return _batched_ste(ctx, x, wmat,
                            _live_rows(g, counts, ctx.seg)) + (None,) * 5


def quantized_matmul(x: torch.Tensor, wmat: torch.Tensor, w_bits: int,
                     m: int = 8, *,
                     context: Optional[ExecContext] = None) -> torch.Tensor:
    """(..., K) @ (K, N) quantized to ``w_bits``; returns x.dtype.

    ``wmat`` may be a strided view (the tied ``lm_head`` passes
    ``embed.T``): it is quantized as it is and made contiguous afterwards,
    in the narrow carrier, before the launch; its STE gradient reaches the
    tensor it views.
    """
    if records_grad(x, wmat):
        return check_grad_fn(
            _QmmCore.apply(x, wmat, w_bits, m, context), "quantized_matmul")
    return _qmm_forward(x, wmat, w_bits, m, context)


def quantized_matmul_batched(x: torch.Tensor, wmat: torch.Tensor,
                             w_bits: int, m: int = 8, *,
                             context: Optional[ExecContext] = None,
                             counts: Optional[torch.Tensor] = None,
                             seg: Optional[int] = None) -> torch.Tensor:
    """(E, C, K) @ (E, K, N) expert GEMM quantized to ``w_bits``; returns
    x.dtype.  On the kernels all experts run as ONE grouped launch.

    x is quantized per (expert, row) and W per (expert, output channel).
    ``counts`` (E, S) integer with a static positive ``seg`` makes the
    launch ragged: expert ``e``'s C rows are S segments of ``seg`` rows, of
    which only the first ``counts[e, s]`` are live (the MoE dispatch passes
    S = batch, seg = capacity).  Live rows equal the dense call; dead rows
    are exact zeros, on every route.
    """
    if x.dim() != 3 or wmat.dim() != 3:
        raise ValueError(f"need (E, C, K) x (E, K, N), got "
                         f"{tuple(x.shape)} x {tuple(wmat.shape)}")
    if counts is not None and (seg is None or seg <= 0):
        raise ValueError("ragged counts need a positive static seg")
    if not records_grad(x, wmat):
        return _qbmm_forward(x, wmat, w_bits, m, context, counts, seg)
    if counts is None:
        out = _QbmmCore.apply(x, wmat, w_bits, m, context)
    else:
        out = _QbmmRaggedCore.apply(x, wmat, counts, w_bits, m, seg,
                                    context)
    return check_grad_fn(out, "quantized_matmul_batched")


def _model_context(quant) -> ExecContext:
    """A model GEMM's context, from the model's QuantConfig: the mesh is
    the ambient one (``dist.sharding.use_mesh``; model code has no mesh
    argument), on the ``"cuda"`` backend, whose kernels run sharded; the
    ATen route takes each GEMM whole."""
    mesh = dist_sharding.current_mesh() if quant.backend == "cuda" else None
    return ExecContext(backend=quant.backend, force_mode=quant.force_mode,
                       mesh=mesh)


def prequant_matmul(x: torch.Tensor, wrec, w_bits: int, m: int = 8, *,
                    batched: bool = False,
                    context: Optional[ExecContext] = None,
                    counts: Optional[torch.Tensor] = None,
                    seg: Optional[int] = None) -> torch.Tensor:
    """Serving GEMM on a pre-quantized weight record ({"q", "scale"}):
    (..., K) @ (K, N), or with ``batched`` (E, C, K) @ (E, K, N) and the
    ragged ``counts``/``seg`` contract of :func:`quantized_matmul_batched`.
    x is quantized per token (per (expert, row)); the record's codes and
    per-channel scale go to the kernel as they are stored, converted only
    where the carrier is wider than the storage (w > 16: int16 -> int32).
    Inference only: an ``x`` that autograd would differentiate raises."""
    if records_grad(x):
        raise RuntimeError("prequant_matmul is inference only: its record "
                           "has no gradient and x's would be wrong; train "
                           "on the fp32 leaves (quantized_matmul)")
    if batched and (x.dim() != 3 or wrec["q"].dim() != 3):
        raise ValueError(f"need (E, C, K) x (E, K, N), got "
                         f"{tuple(x.shape)} x {tuple(wrec['q'].shape)}")
    if counts is not None and not batched:
        raise ValueError("ragged counts require batched=True")
    if counts is not None and (seg is None or seg <= 0):
        raise ValueError("ragged counts need a positive static seg")
    carrier = carrier_dtype(w_bits, m)
    qx, sx = _quantize(x, w_bits, -1, carrier)
    # no copy where storage == carrier
    qw = dist_sharding.to_dtype(wrec["q"], carrier)
    return _quant_gemm(qx, qw, sx, wrec["scale"], w_bits, m, x.dtype,
                       context, counts, seg)


def maybe_quantized_matmul(x: torch.Tensor, wmat: torch.Tensor, quant,
                           name: str) -> torch.Tensor:
    """Dense matmul that routes through the quantized KMM path when the
    model's policy enables it (on a pre-quantized record: the record
    route), and a plain matmul otherwise."""
    if isinstance(wmat, dict):
        return prequant_matmul(x, wmat, quant.bits_for(name), quant.m,
                               context=_model_context(quant))
    if quant is not None and quant.enabled:
        return quantized_matmul(x, wmat, quant.bits_for(name), quant.m,
                                context=_model_context(quant))
    return torch.matmul(x, dist_sharding.full_leaf(wmat).to(x.dtype))


def maybe_quantized_batched(x: torch.Tensor, wmat: torch.Tensor, quant,
                            name: str, counts: Optional[torch.Tensor] = None,
                            seg: Optional[int] = None) -> torch.Tensor:
    """Expert-batched matmul through the quantized KMM path when enabled.

    ``counts``/``seg`` opt into the ragged grouped contract; the
    unquantized path ignores them, as the reference's einsum does, because
    the MoE combine gathers live slots only."""
    if isinstance(wmat, dict):
        return prequant_matmul(x, wmat, quant.bits_for(name), quant.m,
                               batched=True, context=_model_context(quant),
                               counts=counts, seg=seg)
    if quant is not None and quant.enabled:
        return quantized_matmul_batched(x, wmat, quant.bits_for(name),
                                        quant.m,
                                        context=_model_context(quant),
                                        counts=counts, seg=seg)
    return torch.matmul(x, dist_sharding.full_leaf(wmat).to(x.dtype))
