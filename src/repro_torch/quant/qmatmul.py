"""Quantized matmul on the fused KMM kernel, forward only (port of
``repro.quant.qmatmul``'s fused route).

Dynamic per-token activation quantization and per-channel weight
quantization to ``w`` bits, then one fused kernel launch that does the
integer GEMM in the width's mode (MM1 for w <= 8, KMM2 for 9-14, MM2 for
15-16, depth-2 KMM for 17-26), the zero-point correction and the dequant
epilogue.  Two entry points, as in the reference: ``quantized_matmul`` for
(..., K) @ (K, N) dense layers and ``quantized_matmul_batched`` for
(E, C, K) @ (E, K, N) expert GEMMs, which run as one grouped launch (ragged
with ``counts``/``seg``: dead rows exact zeros, see
``kernels.fused_gemm.ragged_row_mask``).  The plan is the reference's
analytic one with its tiles clamped to the (C, K, N) shape
(``_shrink_tiles``), because the clamped ``block_k`` fixes the padded K
that the fp32 combine rounds with.

Not ported yet, and raising rather than changing route: the XLA
digit-recursion GEMM (``_int_dot``) that the reference falls back to
outside the fused windows (w >= 27, recursion deeper than 2 levels) or the
kernel's bounds, ``force_mode="mm2"``,
pre-quantized weight records, and the straight-through backward
(training).
"""
from __future__ import annotations

import math
from dataclasses import replace
from typing import Optional, Tuple

import torch

from repro_torch.core.context import ExecContext
from repro_torch.core.dispatch import ExecPlan, analytic_plan
from repro_torch.core.kmm import max_exact_k, plan_accum_k_bound
from repro_torch.kernels.fused_gemm import fused_gemm, fused_gemm_grouped
from repro_torch.quant.quantize import quantize_symmetric

_NO_FALLBACK = ("the reference runs this GEMM on its XLA digit recursion "
                "(quant/qmatmul._int_dot, core/kmm.kmm_n), which the port "
                "does not have yet (ROADMAP, modules to port: integer "
                "numerics core and quantized matmul fallback)")


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


def _fused_plan_for(shape, w: int, m: int) -> Optional[ExecPlan]:
    """The tile-clamped fused plan for an (M, K, N) GEMM, or None when the
    shape exceeds the kernel's exactness bounds."""
    k_dim = shape[1]
    plan = _shrink_tiles(analytic_plan(w, m, backend="cuda"), shape)
    if plan.is_exact_int and max_exact_k(w) < k_dim:
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
                seg: Optional[int] = None) -> Optional[torch.Tensor]:
    """The GEMM + dequant epilogue on the fused kernel: dense (..., K) x
    (K, N), or batched (E, C, K) x (E, K, N) as one grouped launch.
    Returns None where the reference would take its XLA route."""
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
        return None                     # recursion deeper than 2 levels
    plan = _fused_plan_for((m_dim, k_dim, n_dim), w, m)
    if plan is None:
        return None
    kw = dict(w=w, m=m, mode=_fused_mode(plan), block_k=plan.block_k,
              combine_int32=plan.combine_int32, out_dtype=out_dtype)
    if batched:
        return fused_gemm_grouped(qx.contiguous(), qw.contiguous(),
                                  sx.contiguous(), sw.contiguous(), counts,
                                  seg=seg, **kw)
    out = fused_gemm(qx.reshape(m_dim, k_dim).contiguous(), qw.contiguous(),
                     sx.reshape(m_dim, 1), sw.reshape(1, n_dim), **kw)
    return out.reshape(qx.shape[:-1] + (n_dim,))


def _carrier(w: int, m: int) -> torch.dtype:
    return torch.int8 if w <= m else torch.int16 if w <= 16 else torch.int32


def quantized_matmul(x: torch.Tensor, wmat: torch.Tensor, w_bits: int,
                     m: int = 8, *,
                     context: Optional[ExecContext] = None) -> torch.Tensor:
    """(..., K) @ (K, N) quantized to ``w_bits``; returns x.dtype.

    ``wmat`` may be a strided view (the tied ``lm_head`` passes
    ``embed.T``): it is quantized as it is and made contiguous afterwards,
    in the narrow carrier, before the launch.
    """
    _check_context(context)
    carrier = _carrier(w_bits, m)
    qx, sx = _quantize(x, w_bits, -1, carrier)        # per token
    qw, sw = _quantize(wmat, w_bits, 0, carrier)      # per output channel
    out = _fused_cuda(qx, qw, sx, sw, w_bits, m, x.dtype)
    if out is None:
        raise NotImplementedError(
            f"w={w_bits} GEMM {tuple(x.shape)} x {tuple(wmat.shape)} is "
            f"outside the fused kernel's window or bounds: " + _NO_FALLBACK)
    return out


def quantized_matmul_batched(x: torch.Tensor, wmat: torch.Tensor,
                             w_bits: int, m: int = 8, *,
                             context: Optional[ExecContext] = None,
                             counts: Optional[torch.Tensor] = None,
                             seg: Optional[int] = None) -> torch.Tensor:
    """(E, C, K) @ (E, K, N) expert GEMM quantized to ``w_bits``; returns
    x.dtype.  All experts run as ONE grouped kernel launch.

    x is quantized per (expert, row) and W per (expert, output channel).
    ``counts`` (E, S) integer with a static positive ``seg`` makes the
    launch ragged: expert ``e``'s C rows are S segments of ``seg`` rows, of
    which only the first ``counts[e, s]`` are live (the MoE dispatch passes
    S = batch, seg = capacity).  Live rows equal the dense call; dead rows
    are exact zeros.
    """
    _check_context(context)
    if x.dim() != 3 or wmat.dim() != 3:
        raise ValueError(f"need (E, C, K) x (E, K, N), got "
                         f"{tuple(x.shape)} x {tuple(wmat.shape)}")
    if counts is not None and (seg is None or seg <= 0):
        raise ValueError("ragged counts need a positive static seg")
    carrier = _carrier(w_bits, m)
    qx, sx = _quantize(x, w_bits, -1, carrier)        # per (expert, row)
    qw, sw = _quantize(wmat, w_bits, 1, carrier)      # per (expert, channel)
    out = _fused_cuda(qx, qw, sx, sw, w_bits, m, x.dtype, counts, seg)
    if out is None:
        raise NotImplementedError(
            f"w={w_bits} expert GEMM {tuple(x.shape)} x "
            f"{tuple(wmat.shape)} is outside the fused kernel's window or "
            f"bounds: " + _NO_FALLBACK)
    return out


def _check_context(context: Optional[ExecContext]) -> None:
    ctx = context if context is not None else ExecContext()
    if ctx.force_mode != "auto":
        raise NotImplementedError(f"force_mode={ctx.force_mode!r}: "
                                  + _NO_FALLBACK)


def _model_context(quant) -> ExecContext:
    return ExecContext(backend=quant.backend, force_mode=quant.force_mode)


def _no_prequant(wmat) -> None:
    if isinstance(wmat, dict):
        raise NotImplementedError("pre-quantized weight records are not "
                                  "ported yet (ROADMAP: quant/prequant.py)")


def maybe_quantized_matmul(x: torch.Tensor, wmat: torch.Tensor, quant,
                           name: str) -> torch.Tensor:
    """Dense matmul that routes through the quantized KMM path when the
    model's policy enables it, and a plain matmul otherwise."""
    _no_prequant(wmat)
    if quant is not None and quant.enabled:
        return quantized_matmul(x, wmat, quant.bits_for(name), quant.m,
                                context=_model_context(quant))
    return torch.matmul(x, wmat.to(x.dtype))


def maybe_quantized_batched(x: torch.Tensor, wmat: torch.Tensor, quant,
                            name: str, counts: Optional[torch.Tensor] = None,
                            seg: Optional[int] = None) -> torch.Tensor:
    """Expert-batched matmul through the quantized KMM path when enabled.

    ``counts``/``seg`` opt into the ragged grouped contract; the
    unquantized path ignores them, as the reference's einsum does, because
    the MoE combine gathers live slots only."""
    _no_prequant(wmat)
    if quant is not None and quant.enabled:
        return quantized_matmul_batched(x, wmat, quant.bits_for(name),
                                        quant.m,
                                        context=_model_context(quant),
                                        counts=counts, seg=seg)
    return torch.matmul(x, wmat.to(x.dtype))
