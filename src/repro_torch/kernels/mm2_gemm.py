"""Conventional MM2 integer GEMM on pre-split digit planes (port of
``repro.kernels.mm2_gemm``): the four digit products C1, C10, C01, C0 into
four int32 accumulators and the conventional combine — the baseline that
KMM2's three products are measured against.

On CUDA tensors :func:`mm2_gemm_planes` launches the hand-written Hopper
kernel (``csrc/staged_pipe.cu``, layout mm2) or raises; on CPU tensors it
runs the plain version, :func:`repro_torch.kernels.ref.ref_mm2_planes`.
Planes are the int8 centered digits of ``ops._planes`` (w <= 16).  B's
planes are all the reference's contiguous (K, N), or all K-major
(``t.t()`` of a contiguous (N, K) tensor, as ``ops`` splits them from the
tied ``lm_head``'s ``embed.T``); anything else raises.  Of the
reference's arguments the tile sizes and ``interpret`` are gone: the
kernel picks its own tiles and split-K plan and takes any M, K, N.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import staged_pipe
from repro_torch.kernels.ref import ref_mm2_planes

# Launches of the CUDA kernel; the wrapper adds one where it launches and
# nowhere else (CPU calls run the plain version and count 0).
launches: Dict[str, int] = {"mm2_gemm_planes": 0}

# The largest split point whose centered digits fit s8 (w = 16).
MAX_H = 8


def reset_launches() -> None:
    launches["mm2_gemm_planes"] = 0


def mm2_gemm_planes(a1: torch.Tensor, a0: torch.Tensor, b1: torch.Tensor,
                    b0: torch.Tensor, *, h: int,
                    combine_int32: bool = False) -> torch.Tensor:
    """MM2 GEMM on int8 digit planes a1, a0 (M, K) and b1, b0 (K, N), split
    at ``h``.  Returns (M, N) int32 if ``combine_int32`` else float32."""
    k_major = staged_pipe.check_operands("mm2_gemm_planes", [a1, a0],
                                         [b1, b0], (torch.int8,))
    if not 1 <= h <= MAX_H:
        raise ValueError(f"mm2_gemm_planes: digits fit s8 only for "
                         f"1 <= h <= {MAX_H}, got h={h}")
    if a1.device.type == "cpu":
        return ref_mm2_planes(a1, a0, b1, b0, h,
                              combine_int32=combine_int32)
    out = staged_pipe.launch("mm2", a1, a0, b1, b0, h=h,
                             combine_int32=combine_int32, b_kmajor=k_major)
    if out.numel():    # an empty output launches nothing
        launches["mm2_gemm_planes"] += 1
    return out
