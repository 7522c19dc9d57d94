"""Area-Unit (AU) circuit-area model — paper Eqs. (16)-(23), Fig. 12 (port
of ``repro.core.area``; pure Python).

One AU = the area of a full adder.  Eq. (16): ADD^[w] = w AU,
FF^[w] = 0.7 w AU, MULT^[w] = w^2 AU.  The model reproduces the paper's
fixed-precision architecture comparison (MM1 vs KSMM vs KMM) including the
Algorithm-5 accumulator area reduction (Eq. 18) and the recursion-depth
selection used for Fig. 12.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.core.complexity import clog2

FF_RATIO = 19.5 / 28.0  # ~0.7: D-flip-flop transistors / full-adder transistors


def area_add(w: int) -> float:
    return float(w)


def area_ff(w: int) -> float:
    return FF_RATIO * w


def area_mult(w: int) -> float:
    return float(w) ** 2


def _ceil_half(w: int) -> int:
    return -(-w // 2)


def area_accum(w2: int, *, w_a: int, p: int = 4) -> float:
    """Per-accumulator area of a 2w-bit accumulation (w2 = 2w) under
    Algorithm 5 (Eq. 18): p accumulators share one wide adder+register."""
    w_p = clog2(p)
    total_p = (p - 1) * area_add(w2 + w_p) + area_add(w2 + w_a) + area_ff(w2 + w_a)
    return total_p / p


def area_mm1(w: int, *, x: int = 64, y: int = 64, p: int = 4) -> float:
    """Eq. (17): baseline MM1 MXU area."""
    w_a = clog2(x)
    per_pe = area_mult(w) + 3 * area_ff(w) + area_accum(2 * w, w_a=w_a, p=p)
    return x * y * per_pe


def area_ksm(n: int, w: int) -> float:
    """Eq. (21): recursive KSM multiplier area (c0 add free via concat)."""
    if n == 1:
        return area_mult(w)
    lo, hi = w // 2, _ceil_half(w)
    a = area_add(2 * w) + 2 * (area_add(2 * hi + 4) + area_add(hi))
    a += area_ksm(n // 2, max(lo, 1))
    a += area_ksm(n // 2, hi + 1)
    a += area_ksm(n // 2, hi)
    return a


def area_ksmm(n: int, w: int, *, x: int = 64, y: int = 64, p: int = 4) -> float:
    """Eq. (20): MM1 MXU with KSM multipliers in place of conventional ones."""
    w_a = clog2(x)
    per_pe = area_ksm(n, w) + 3 * area_ff(w) + area_accum(2 * w, w_a=w_a, p=p)
    return x * y * per_pe


def area_kmm(n: int, w: int, *, x: int = 64, y: int = 64, p: int = 4) -> float:
    """Eq. (22): KMM architecture area (3 sub-MXUs + pre/post adders)."""
    if n == 1:
        return area_mm1(w, x=x, y=y, p=p)
    w_a = clog2(x)
    lo, hi = w // 2, _ceil_half(w)
    a = 2 * x * area_add(hi)
    a += 2 * y * (area_add(2 * hi + 4 + w_a) + area_add(2 * w + w_a))
    a += area_kmm(n // 2, max(lo, 1), x=x, y=y, p=p)
    a += area_kmm(n // 2, hi + 1, x=x, y=y, p=p)
    a += area_kmm(n // 2, hi, x=x, y=y, p=p)
    return a


def best_kmm_levels(w: int, *, x: int = 64, y: int = 64, p: int = 4,
                    max_r: int = 4) -> int:
    """Fig. 12 rule: as many recursion levels as possible while still
    reducing area, minimum one level."""
    best_r, best_a = 1, area_kmm(2, w, x=x, y=y, p=p)
    for r in range(2, max_r + 1):
        a = area_kmm(2**r, w, x=x, y=y, p=p)
        if a < best_a:
            best_r, best_a = r, a
    return best_r


@dataclass(frozen=True)
class AuEfficiency:
    """Eq. (23) relative form: throughput/AU of ARCH over throughput/AU of
    MM1 (throughput roofs are equal for equal X/Y)."""

    arch: str
    w: int
    relative: float


def au_efficiency_vs_mm1(arch: str, w: int, *, n: int | None = None,
                         x: int = 64, y: int = 64, p: int = 4) -> AuEfficiency:
    base = area_mm1(w, x=x, y=y, p=p)
    if arch == "mm1":
        rel = 1.0
    elif arch == "ksmm":
        rel = base / area_ksmm(n or 2, w, x=x, y=y, p=p)
    elif arch == "kmm":
        r = int(math.log2(n)) if n else best_kmm_levels(w, x=x, y=y, p=p)
        rel = base / area_kmm(2**r, w, x=x, y=y, p=p)
    else:
        raise ValueError(f"unknown arch {arch!r}")
    return AuEfficiency(arch, w, rel)
