"""Operation-count complexity models — paper Eqs. (2)-(8), Fig. 5 (port of
``repro.core.complexity``; pure Python).

Counts are kept per (operation kind, bitwidth) so that the area model
(:mod:`repro_torch.core.area`) and ``tune.space.cost_prior`` can weigh
them; ``total`` collapses to the paper's "arithmetic complexity" (Eqs.
6-8).  The recursions mirror the paper's equations, including the bitwidth
bookkeeping of the ADD and SHIFT terms; the closed forms (6)-(8) are
leading-order for n > 2 (exact at n = 2).
"""
from __future__ import annotations

import math
from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, Tuple

Key = Tuple[str, int]  # (op kind, bitwidth)

MULT, ADD, ACCUM, SHIFT = "MULT", "ADD", "ACCUM", "SHIFT"


@dataclass
class OpCount:
    counts: Counter = field(default_factory=Counter)

    def add(self, kind: str, width: int, count: float) -> "OpCount":
        self.counts[(kind, width)] += count
        return self

    def __add__(self, other: "OpCount") -> "OpCount":
        out = OpCount(Counter(self.counts))
        out.counts.update(other.counts)
        return out

    def scaled(self, k: float) -> "OpCount":
        return OpCount(Counter({key: v * k for key, v in self.counts.items()}))

    def total(self, kinds=(MULT, ADD, ACCUM, SHIFT)) -> float:
        return sum(v for (kind, _), v in self.counts.items() if kind in kinds)

    def total_of(self, kind: str) -> float:
        return sum(v for (k, _), v in self.counts.items() if k == kind)

    def by_kind(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for (kind, _), v in self.counts.items():
            out[kind] = out.get(kind, 0.0) + v
        return out


def _ceil_half(w: int) -> int:
    return -(-w // 2)


def clog2(x: int) -> int:
    return max(int(math.ceil(math.log2(x))), 0) if x > 1 else 0


def _mm1_base(w: int, d: int, w_a: int, p: int | None) -> OpCount:
    """Eq. (2b): d^3 (MULT^[w] + ACCUM^[2w]); ACCUM decomposed per Eq. (10)."""
    c = OpCount()
    c.add(MULT, w, d**3)
    if p is None:
        c.add(ACCUM, 2 * w + w_a, d**3)
    else:
        w_p = clog2(p)
        groups = d**3 / p
        c.add(ADD, 2 * w + w_p, groups * (p - 1))
        c.add(ADD, 2 * w + w_a, groups)
    return c


def mm_complexity(n: int, w: int, d: int, *, w_a: int | None = None,
                  p: int | None = None) -> OpCount:
    """C(MM_n^[w]) for d x d matrices (Eq. 2)."""
    w_a = clog2(d) if w_a is None else w_a
    if n == 1:
        return _mm1_base(w, d, w_a, p)
    lo, hi = w // 2, _ceil_half(w)
    c = mm_complexity(n // 2, max(lo, 1), d, w_a=w_a, p=p)
    c = c + mm_complexity(n // 2, hi, d, w_a=w_a, p=p).scaled(3)
    c.add(ADD, w + w_a, d * d)
    c.add(ADD, 2 * w + w_a, 2 * d * d)
    c.add(SHIFT, w, d * d)
    c.add(SHIFT, hi, d * d)
    return c


def ksm_complexity(n: int, w: int) -> OpCount:
    """C(KSM_n^[w]): one scalar Karatsuba product (Eq. 3)."""
    if n == 1:
        return OpCount().add(MULT, w, 1)
    lo, hi = w // 2, _ceil_half(w)
    c = ksm_complexity(n // 2, max(lo, 1))
    c = c + ksm_complexity(n // 2, hi + 1)
    c = c + ksm_complexity(n // 2, hi)
    c.add(ADD, 2 * w, 2)
    c.add(ADD, hi, 2)
    c.add(ADD, 2 * hi + 4, 2)
    c.add(SHIFT, w, 1)
    c.add(SHIFT, hi, 1)
    return c


def ksmm_complexity(n: int, w: int, d: int, *, w_a: int | None = None,
                    p: int | None = None) -> OpCount:
    """C(KSMM_n^[w]): conventional matmul with KSM scalar products
    (Eq. 4)."""
    w_a = clog2(d) if w_a is None else w_a
    c = ksm_complexity(n, w).scaled(d**3)
    if p is None:
        c.add(ACCUM, 2 * w + w_a, d**3)
    else:
        w_p = clog2(p)
        groups = d**3 / p
        c.add(ADD, 2 * w + w_p, groups * (p - 1))
        c.add(ADD, 2 * w + w_a, groups)
    return c


def kmm_complexity(n: int, w: int, d: int, *, w_a: int | None = None,
                   p: int | None = None) -> OpCount:
    """C(KMM_n^[w]) for d x d matrices (Eq. 5)."""
    w_a = clog2(d) if w_a is None else w_a
    if n == 1:
        return _mm1_base(w, d, w_a, p)
    lo, hi = w // 2, _ceil_half(w)
    c = kmm_complexity(n // 2, max(lo, 1), d, w_a=w_a, p=p)
    c = c + kmm_complexity(n // 2, hi + 1, d, w_a=w_a, p=p)
    c = c + kmm_complexity(n // 2, hi, d, w_a=w_a, p=p)
    c.add(ADD, 2 * hi + 4 + w_a, 2 * d * d)
    c.add(ADD, 2 * w + w_a, 2 * d * d)
    c.add(ADD, hi, 2 * d * d)
    c.add(SHIFT, w, d * d)
    c.add(SHIFT, hi, d * d)
    return c


# Eqs. (6)-(8): closed-form arithmetic complexity (leading order for n > 2).

def mm_arith(n: int, d: int) -> float:
    return 2 * n**2 * d**3 + 5 * (n / 2) ** 2 * d**2


def ksmm_arith(n: int, d: int) -> float:
    return (1 + 11 * (n / 2) ** math.log2(3)) * d**3


def kmm_arith(n: int, d: int) -> float:
    return (n / 2) ** math.log2(3) * (6 * d**3 + 8 * d**2)
