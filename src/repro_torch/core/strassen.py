"""One tile-level Strassen split over the digit-level KMM stack (port of
``repro.core.strassen``).

KMM cuts multiply work 3/4 a recursion level over bitwidth digits;
Strassen cuts it 7/8 a level over (M, N, K) tiles.  The two recursions are
orthogonal: this module runs one Strassen level and hands each of the 7
sub-GEMMs back to the execution seam (``run_sub``, which
``kernels.ops.run_plan`` passes in), so a sub-product can be the ATen
digit recursion or the fused kernel.

  * ``"strassen"``      — the 7 products run on the ATen route's exact plan
    at ``w + 1`` (the reference's ``analytic_plan(w + 1, backend="xla",
    exact=True)``; in the MM1 window the exact int32 product, ``xla_ref``).
  * ``"strassen+kmm2"`` — the 7 products run on the fused kernel
    (``"cuda"``) at ``w + 1`` with ``combine_int32=True``: seven fused
    launches a GEMM.

Strassen's pre-additions (``A11 + A22`` ...) grow operands by one bit,
hence ``w + 1``.  The pre-adds and the combine are int32 ring arithmetic:
exact while the composed bound ``tune.space.strassen_k_bound`` holds.
M, K and N are zero-padded to even before the quadrant split and the
output is sliced back.
"""
from __future__ import annotations

from dataclasses import replace
from typing import Callable, Tuple

import torch

from repro_torch.core.dispatch import ExecPlan, analytic_plan

Shape = Tuple[int, int, int]

STRASSEN_VARIANTS = ("strassen", "strassen+kmm2")


def strassen_sub_shape(shape: Shape) -> Shape:
    """(M, K, N) of each of the 7 sub-GEMMs: the even-padded halves."""
    m, k, n = shape
    return (-(-m // 2), -(-k // 2), -(-n // 2))


def strassen_sub_plan(plan: ExecPlan) -> ExecPlan:
    """The ExecPlan each of the 7 tile products runs, derived from the
    parent's variant alone: ``w + 1``, int32 combines."""
    if plan.variant not in STRASSEN_VARIANTS:
        raise ValueError(f"not a strassen plan: {plan.variant!r}")
    w_sub = plan.w + 1
    if plan.variant == "strassen+kmm2":
        return ExecPlan("fused", w_sub, plan.m, backend="cuda",
                        block_k=plan.block_k, combine_int32=True,
                        depth=0 if w_sub <= plan.m else 1,
                        source=plan.source)
    sub = analytic_plan(w_sub, plan.m, backend="aten", exact=True)
    if sub.variant == "mm1":
        # the ATen route's MM1-window plan is the single exact int32 dot
        sub = replace(sub, variant="xla_ref", depth=0)
    return replace(sub, source=plan.source)


def _quadrants(x: torch.Tensor):
    m2, k2 = x.shape[0] // 2, x.shape[1] // 2
    return (x[:m2, :k2], x[:m2, k2:], x[m2:, :k2], x[m2:, k2:])


def strassen_matmul(a: torch.Tensor, b: torch.Tensor, *, plan: ExecPlan,
                    run_sub: Callable[[torch.Tensor, torch.Tensor, ExecPlan],
                                      torch.Tensor]) -> torch.Tensor:
    """One Strassen level on (M, K) x (K, N) integer operands: the 7
    classical products (``run_sub(x, y, sub_plan)`` each), int32 ring
    pre-adds and combine."""
    m_dim, k_dim = a.shape
    n_dim = b.shape[1]
    sub = strassen_sub_plan(plan)
    ai = a.to(torch.int32)
    bi = b.to(torch.int32)
    if (m_dim | k_dim) & 1:
        ai = torch.nn.functional.pad(ai, (0, k_dim & 1, 0, m_dim & 1))
    if (k_dim | n_dim) & 1:
        bi = torch.nn.functional.pad(bi, (0, n_dim & 1, 0, k_dim & 1))
    a11, a12, a21, a22 = _quadrants(ai)
    b11, b12, b21, b22 = _quadrants(bi)
    p1 = run_sub(a11 + a22, b11 + b22, sub)
    p2 = run_sub(a21 + a22, b11, sub)
    p3 = run_sub(a11, b12 - b22, sub)
    p4 = run_sub(a22, b21 - b11, sub)
    p5 = run_sub(a11 + a12, b22, sub)
    p6 = run_sub(a21 - a11, b11 + b12, sub)
    p7 = run_sub(a12 - a22, b21 + b22, sub)
    c11 = p1 + p4 - p5 + p7
    c12 = p3 + p5
    c21 = p2 + p4
    c22 = p1 - p2 + p3 + p6
    out = torch.cat([torch.cat([c11, c12], dim=1),
                     torch.cat([c21, c22], dim=1)], dim=0)
    return out[:m_dim, :n_dim]
