"""Multiplier compute efficiency — paper Eqs. (11)-(15), Fig. 11 (port of
``repro.core.efficiency``; pure Python).

The metric (Eq. 12) measures *effective m-bit multiplications per instantiated
multiplier per clock cycle*: how much algebraic optimization an architecture
extracts from its area-dominant resource, independent of frequency and of the
executed bitwidth w.

    efficiency = (N_w_products * 4**r_conv) / (cycles * n_multipliers)

where ``N_w_products * 4**r_conv`` is the m-bit-mult count a conventional
algorithm (SM/MM) would need (Eq. 13) and ``cycles`` the measured/modeled
execution time in clock cycles.

Roofs: MM = 1 (Eq. 14), KMM = (4/3)**r (Eq. 15), FFIP = 2, FFIP+KMM =
2*(4/3)**r (Section V-B).
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.dispatch import (conv_mults_per_product, conv_recursion,
                                      select_mode)


def roof(arch: str, w: int, m: int) -> float:
    """Fixed-precision efficiency roofs (Eqs. 14, 15 + FFIP variants)."""
    r = conv_recursion(w, m)
    if arch == "mm":
        return 1.0
    if arch == "kmm":
        return (4.0 / 3.0) ** r
    if arch == "ffip":
        return 2.0
    if arch == "ffip_kmm":
        return 2.0 * (4.0 / 3.0) ** r
    raise ValueError(f"unknown arch {arch!r}")


def precision_scalable_roof(arch: str, w: int, m: int) -> float:
    """Fig. 11: per-bitwidth roofs of the precision-scalable architectures.

    Both architectures spend `passes` tile reads per w-bit tile product; the
    conventional-algebra equivalent work is 4**r_conv m-bit passes.
    """
    conv = conv_mults_per_product(w, m)
    if arch == "kmm":
        passes = select_mode(w, m).passes
    elif arch == "mm":
        passes = 1 if w <= m else 4 ** conv_recursion(w, m)
    elif arch == "ffip":
        passes = (1 if w <= m else 4 ** conv_recursion(w, m)) / 2.0
    elif arch == "ffip_kmm":
        passes = select_mode(w, m).passes / 2.0
    else:
        raise ValueError(f"unknown arch {arch!r}")
    return conv / passes


@dataclass(frozen=True)
class Measured:
    """A measured/modeled execution for Eq. (12)."""

    n_w_products: float      # w-bit mults needed by conventional algebra
    w: int
    m: int
    cycles: float
    n_multipliers: int

    @property
    def efficiency(self) -> float:
        conv = self.n_w_products * conv_mults_per_product(self.w, self.m)
        return conv / (self.cycles * self.n_multipliers)


def gops(n_ops: float, seconds: float) -> float:
    return n_ops / seconds / 1e9
