"""Operation-count complexity models, paper Eqs. (2) and (5) (port of the
part of ``repro.core.complexity`` that ``tune.space.cost_prior`` needs).

Counts are kept per (operation kind, bitwidth), as the reference keeps
them; the recursions mirror the paper's equations, including the bitwidth
bookkeeping of the ADD and SHIFT terms.  The area model, KSM/KSMM and the
closed forms (Eqs. 3, 4, 6-8) are not ported.
"""
from __future__ import annotations

import math
from collections import Counter
from dataclasses import dataclass, field

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

    def total_of(self, kind: str) -> float:
        return sum(v for (k, _), v in self.counts.items() if k == kind)


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
