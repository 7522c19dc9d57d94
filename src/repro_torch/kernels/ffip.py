"""FFIP, the free-pipeline fast inner product (port of
``repro.kernels.ffip``; the paper's prior work [6], Table II).

FFIP halves the multiplier count by computing, inside each processing
element, ``(a_even + b_odd) * (a_odd + b_even)`` and subtracting row-only
and column-only correction sums.  It is a PE-array trick with no kernel of
its own in the reference (a matmul unit cannot pre-add across its
operands), so the port, like the reference, has a literal version to check
the algebra and the multiply count behind Table II.
"""
from __future__ import annotations

import torch

from repro_torch.core.kmm import _wrap_int32


def ffip_gemm_literal(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Literal FFIP in int32 ring arithmetic (materializes (M, K/2, N):
    small shapes only):

        c_ij = sum_k (ae_ik + bo_kj)(ao_ik + be_kj) - sum_k ae_ik*ao_ik
               - sum_k be_kj*bo_kj
    """
    if a.shape[1] % 2:
        raise ValueError("FFIP needs even K")
    i32 = torch.int32
    ae, ao = a[:, 0::2].to(i32), a[:, 1::2].to(i32)
    be, bo = b[0::2, :].to(i32), b[1::2, :].to(i32)
    lhs = ae[:, :, None] + bo[None, :, :]
    rhs = ao[:, :, None] + be[None, :, :]
    prod = _wrap_int32((lhs * rhs).sum(dim=1))
    a_corr = _wrap_int32((ae * ao).sum(dim=1, keepdim=True))
    b_corr = _wrap_int32((be * bo).sum(dim=0, keepdim=True))
    return prod - a_corr - b_corr


def ffip_mults(m: int, k: int, n: int) -> int:
    """Multiplications FFIP spends on an (M, K) x (K, N) GEMM: half the
    MACs plus the amortized row and column correction products."""
    return m * n * (k // 2) + m * (k // 2) + n * (k // 2)
