"""Algorithm 5: matmul with reduced accumulator complexity (port of
``repro.core.accum``).

The paper pre-accumulates ``p`` products on a narrow ``2w + ceil(log2 p)``
bit adder before one add into the wide running sum (Eq. 10), cutting wide
adds and accumulator registers by ``p`` (Fig. 6).  In tensor form the
contraction axis K is blocked into groups of ``p``: products within a group
reduce first (the narrow pre-sum, one exact leaf product a group), then
the group sums reduce into the running accumulator.  The result is
bit-identical to a flat accumulation; what changes is the hardware cost.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.kmm import (MATMUL_DIMS, _wrap_int32, dot_general,
                                  exact_dot)

DEFAULT_P = 4  # the paper's evaluation setting


def preaccum_matmul(a: torch.Tensor, b: torch.Tensor, *, p: int = DEFAULT_P,
                    accum_dtype=torch.int32,
                    bits: Optional[int] = None) -> torch.Tensor:
    """Algorithm 5 on (..., M, K) x (K, N): two-level accumulation.  K must
    be divisible by ``p``.  ``bits`` bounds the operands' magnitude by
    ``2**bits`` for the card's exact leaf (default: their dtypes' range)."""
    m_axis, k = a.shape[:-1], a.shape[-1]
    if k % p:
        raise ValueError(f"K={k} not divisible by pre-accumulation p={p}")
    n = b.shape[-1]
    groups = k // p
    a_g = a.reshape(*m_axis, groups, p)
    b_g = b.reshape(groups, p, n)
    # Narrow pre-sum: contract only within each group of p.
    partial = dot_general(
        a_g, b_g, (((a_g.dim() - 1,), (1,)), ((a_g.dim() - 2,), (0,))),
        lambda x, y: exact_dot(x, y, bits=bits, accum_dtype=accum_dtype))
    # Wide accumulation: one add a group into the running sum.
    out = partial.to(torch.int64).sum(dim=0)
    return _wrap_int32(out) if accum_dtype == torch.int32 else out


def _canon(dims):
    return tuple(tuple(tuple(axes) for axes in pair) for pair in dims)


def preaccum_mm1(p: int = DEFAULT_P, accum_dtype=torch.int32):
    """Algorithm 5 as the ``mm1`` hook of Algorithms 3/4; only the plain
    (M, K) x (K, N) dimension numbers pre-accumulate."""

    def mm1(a: torch.Tensor, b: torch.Tensor, dims, *,
            bits: Optional[int] = None) -> torch.Tensor:
        if _canon(dims) != _canon(MATMUL_DIMS):
            return dot_general(a, b, dims, lambda x, y: exact_dot(
                x, y, bits=bits, accum_dtype=accum_dtype))
        return preaccum_matmul(a, b, p=p, accum_dtype=accum_dtype,
                               bits=bits)

    return mm1


def wide_adds_saved(k: int, p: int = DEFAULT_P) -> float:
    """Fraction of wide (2w + log2 d)-bit adds removed by Algorithm 5."""
    return 1.0 - (k // p) / k
