"""Exactness bounds of the integer GEMM (port of ``repro.core.kmm``'s
``max_exact_k`` and ``repro.tune.space``'s accumulator bounds).

The digit-recursion GEMMs themselves (``kmm_n``, ``mm_n``) are not ported:
they are the reference's XLA route, which the port does not have yet.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.dispatch import ExecPlan


def max_exact_k(w: int, carrier_bits: int = 31) -> int:
    """Largest K for which a w-bit product sum is exact in int32: the
    recombined value ``K * (2**w - 1)**2`` must fit, so
    ``K <= 2**(carrier_bits - 2w)`` (a power-of-two under-approximation)."""
    head = carrier_bits - 2 * w
    return max(1 << head, 1) if head > 0 else 0


def leaf_mag_bits(mode: str, w: int) -> int:
    """ceil(log2) bound on the largest digit magnitude entering a product
    pass: kmm2 pre-adder 2^h, mm2 digits 2^(h-1), kmm4 nested leaves."""
    h = -(-w // 2)
    if mode == "kmm2":
        return h
    if mode == "mm2":
        return max(h - 1, 1)
    if mode == "kmm4":
        w1 = h + 1
        h2 = -(-w1 // 2)
        mag = (1 << max(w1 - h2 - 1, 0)) + (1 << h2)
        return max(mag.bit_length(), 1)
    raise ValueError(f"no digit magnitude for mode {mode!r}")


def digit_accum_k_bound(w: int) -> int:
    """Largest padded K for which each KMM2 digit-plane product accumulates
    exactly in int32 (digit magnitudes ~ 2**(w/2): K up to 2**(31 - w - 2))."""
    head = 31 - w - 2
    return 1 << head if head > 0 else 1


def plan_accum_k_bound(plan: ExecPlan) -> Optional[int]:
    """Per-digit int32 accumulator headroom of a plan: the largest padded K
    for which every digit accumulator stays exact.  None for the MM1 window,
    whose single accumulator is bounded by ``max_exact_k`` instead."""
    if plan.variant == "mm1" or (plan.variant == "fused"
                                 and plan.w <= plan.m):
        return None
    if plan.variant in ("mm2", "fused_mm2"):
        mode = "mm2"
    elif plan.depth == 2:
        mode = "kmm4"
    else:
        return digit_accum_k_bound(plan.w)
    head = 30 - 2 * leaf_mag_bits(mode, plan.w)
    return 1 << head if head > 0 else 1
