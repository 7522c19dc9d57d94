"""Oracles and plain versions of the staged GEMM kernels (port of
``repro.kernels.ref``).

``ref_int_gemm``, ``ref_kmm2_planes`` and ``ref_mm2_planes`` are the plain
PyTorch versions of the staged kernels 2-4 (``mm1_gemm``,
``kmm2_gemm_planes``, ``mm2_gemm_planes``): the kernel wrappers run them for
CPU tensors, ``ops.run_plan(..., use_ref_kernels=True)`` runs them on any
device, and ``chip_smoke.py`` holds each kernel to them on the card.  They
compute what the kernels compute, bit for bit: every digit product is an
int32 accumulator (modulo 2^32, as the reference's int32 dot), the combine
follows the reference's order in int32 or one rounded fp32 operation at a
time.  Digit products run as float64 matmuls, which are exact here (see
:func:`_digit_dot`).  ``ref_int_gemm_i64`` is the numpy int64 oracle.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.fused_gemm import _combine_f32, _wrap_int32

# float64 sums of integer products stay exact below 2^53: operands below
# 2^16 in magnitude (int8 and int16 planes and their pre-adder sums) give
# products below 2^32, so K up to 2^21.
_MAX_K = 1 << 21


def ref_int_gemm_i64(a, b) -> np.ndarray:
    """numpy int64 oracle — exact for all w <= 16 and any practical K.
    Accepts numpy arrays or CPU tensors."""
    return np.asarray(a, dtype=np.int64) @ np.asarray(b, dtype=np.int64)


def _digit_dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(M, K) @ (K, N) of integers below 2^16 in magnitude, as an int32
    accumulator (int64 values wrapped modulo 2^32)."""
    if x.shape[-1] > _MAX_K:
        raise ValueError(f"K={x.shape[-1]} above {_MAX_K}: the float64 "
                         f"digit product would not be exact")
    out = torch.matmul(x.to(torch.float64), y.to(torch.float64))
    return _wrap_int32(out.to(torch.int64)).to(torch.int64)


def _check_planes(*planes: torch.Tensor) -> None:
    for t in planes:
        if t.dtype not in (torch.int8, torch.int16):
            raise TypeError(f"digit planes are int8 or int16, got {t.dtype}")


def ref_int_gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int32 GEMM oracle on int8 or int16 operands: (M, K) @ (K, N)
    with int32 accumulation.  The plain version of ``mm1_gemm``."""
    _check_planes(a, b)
    return _digit_dot(a, b).to(torch.int32)


def split_planes(x: torch.Tensor, h: int):
    """Centered s8 digit planes of integer ``x`` split at ``h``: (hi,
    lo_centered, z) with x == (hi << h) + lo_centered + z elementwise."""
    z = 1 << (h - 1)
    hi = (x >> h).to(torch.int8)
    lo = ((x & ((1 << h) - 1)) - z).to(torch.int8)
    return hi, lo, z


def ref_digit_planes(x: torch.Tensor, w: int):
    """The centered s8 digit planes the staged kernels take.

    Returns (hi, lo_centered, h, z) with x == (hi << h) + lo_centered + z
    elementwise, hi and lo_centered both in s8 range for w <= 16.
    """
    h = -(-w // 2)
    hi, lo, z = split_planes(x.to(torch.int32), h)
    return hi, lo, h, z


def _combine_kmm2_int(c1, cs, c0, h: int) -> torch.Tensor:
    """Fig. 9 post-adder in the int32 ring: C1<<2h + (Cs-C1-C0)<<h + C0."""
    return _wrap_int32((c1 << (2 * h)) + ((cs - c1 - c0) << h) + c0)


def ref_kmm2_planes(a1: torch.Tensor, a0: torch.Tensor, b1: torch.Tensor,
                    b0: torch.Tensor, h: int,
                    combine_int32: bool = False) -> torch.Tensor:
    """The KMM2 kernel's math on digit planes (no tiling): C1 = A1.B1,
    Cs = (A1+A0).(B1+B0), C0 = A0.B0, then the post-adder at ``h``."""
    _check_planes(a1, a0, b1, b0)
    a1, a0, b1, b0 = (t.to(torch.int64) for t in (a1, a0, b1, b0))
    c1 = _digit_dot(a1, b1)
    cs = _digit_dot(a1 + a0, b1 + b0)
    c0 = _digit_dot(a0, b0)
    if combine_int32:
        return _combine_kmm2_int(c1, cs, c0, h)
    return _combine_f32("kmm2", [c1, cs, c0], h)


def ref_mm2_planes(a1: torch.Tensor, a0: torch.Tensor, b1: torch.Tensor,
                   b0: torch.Tensor, h: int,
                   combine_int32: bool = False) -> torch.Tensor:
    """The MM2 kernel's math on digit planes (no tiling): the four digit
    products C1, C10, C01, C0 and the conventional combine at ``h``."""
    _check_planes(a1, a0, b1, b0)
    a1, a0, b1, b0 = (t.to(torch.int64) for t in (a1, a0, b1, b0))
    c1, c10, c01, c0 = (_digit_dot(x, y) for x, y in
                        ((a1, b1), (a1, b0), (a0, b1), (a0, b0)))
    if combine_int32:
        return _wrap_int32((c1 << (2 * h)) + ((c10 + c01) << h) + c0)
    return _combine_f32("mm2", [c1, c10, c01, c0], h)
