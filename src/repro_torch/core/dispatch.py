"""Precision-scalable execution-mode dispatch (paper Section IV-C, Fig. 10).

Port of ``repro.core.dispatch``: the paper's mode rule (``select_mode``) and
the analytic ``ExecPlan`` the fused kernel runs.  Given input bitwidth ``w``
and multiplier bitwidth ``m``:

  * ``w <= m``           -> MM1  (1 tile pass)
  * ``m < w <= 2m - 2``  -> KMM2 (3 tile passes)
  * ``2m - 2 < w <= 2m`` -> MM2  (4 tile passes)

and wider ``w`` recurses.  The tuning-table path (``select_plan``) is not
ported: every plan here is the analytic one.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass


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


@dataclass(frozen=True)
class ExecPlan:
    """A resolved way to run one integer GEMM: kernel variant, backend,
    K tile, combine precision and digit-recursion depth.  Of the
    reference's tiles only ``block_k`` is kept: it fixes the padded K that
    the fp32 combine rounds with, while M/N tiles never change a value and
    the CUDA kernel picks its own."""

    variant: str             # "fused" | "fused_mm2" | "mm1" | "kmm2" | "mm2"
    w: int
    m: int = 8
    backend: str = "cuda"
    block_k: int = 256
    combine_int32: bool = False  # int32 post-adder (exact) vs fp32
    depth: int = 1               # digit-recursion levels (digits = 2**depth)

    @property
    def is_exact_int(self) -> bool:
        """True when the plan computes the exact integer product in int32."""
        if self.variant == "fused" and self.w <= self.m:
            return True
        return self.combine_int32 or self.variant == "mm1"


DEFAULT_BLOCK_K = 256


def analytic_plan(w: int, m: int = 8, *, backend: str = "cuda",
                  exact: bool = False) -> ExecPlan:
    """The paper's dispatch rule as an ExecPlan with the default K tile.

    On ``backend="cuda"`` (the counterpart of the reference's "pallas") every
    window through depth-2 recursion routes to the fused single-pass kernel:
    MM1 and KMM2 as "fused", the (2m-2, 2m] boundary as "fused_mm2", and
    4-digit recursion as "fused" at depth 2.
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
