"""KMM2 integer GEMM on pre-split digit planes (port of
``repro.kernels.kmm_gemm``): the paper's Fig. 8 pre-adders, three digit
products C1, Cs, C0 into three int32 accumulators, and the Fig. 9
post-adder in int32 or fp32.

On CUDA tensors :func:`kmm2_gemm_planes` launches the hand-written Hopper
kernel (``csrc/staged_pipe.cu``) or raises; on CPU tensors it runs the plain
version, :func:`repro_torch.kernels.ref.ref_kmm2_planes`.  Planes are int8
(depth 1: the centered split of ``ops._planes``, w <= 14) or int16 (the
depth-2 branches of ``ops._kmm4_core``), and every value in them must fit
s8, as the reference's callers guarantee: Hopper has no int16 MMA, so the
kernel narrows int16 planes to s8 in shared memory.  B's planes are all
the reference's contiguous (K, N), or all K-major (``t.t()`` of a
contiguous (N, K) tensor, as ``ops`` splits them from the tied
``lm_head``'s ``embed.T``); anything else raises.
Two routes, counted apart:

  * ``s8``: three products, the pre-adder operands formed from the digit
    fragments — int8 planes, and int16 planes split at ``h <= 6``
    (w <= 22 at depth 2);
  * ``split``: int16 planes split at ``h = 7`` (w 23-26), whose pre-adder
    sums reach 189: four leaf products, Cs rebuilt as C1 + C0 + the cross
    products, the same integer.

Of the reference's arguments the tile sizes and ``interpret`` are gone: the
kernel picks its own tiles and split-K plan and takes any M, K, N.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import staged_pipe
from repro_torch.kernels.ref import ref_kmm2_planes

# Launches of the CUDA kernel by route; the wrapper adds one where it
# launches and nowhere else (CPU calls run the plain version and count 0).
launches: Dict[str, int] = {"kmm2_gemm_planes_s8": 0,
                            "kmm2_gemm_planes_split": 0}

# The largest split point whose digits fit s8: the depth-1 pre-adder at
# h = 7 (w = 14), the depth-2 leaves at h2 = 7 (w = 26).
MAX_H = 7


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0


def route(dtype: torch.dtype, h: int) -> str:
    """The kernel route for planes of ``dtype`` split at ``h``."""
    return "split" if dtype == torch.int16 and h >= MAX_H else "s8"


def kmm2_gemm_planes(a1: torch.Tensor, a0: torch.Tensor, b1: torch.Tensor,
                     b0: torch.Tensor, *, h: int,
                     combine_int32: bool = False) -> torch.Tensor:
    """KMM2 GEMM on digit planes a1, a0 (M, K) and b1, b0 (K, N), split at
    ``h``.  Returns (M, N) int32 if ``combine_int32`` else float32."""
    k_major = staged_pipe.check_operands("kmm2_gemm_planes", [a1, a0],
                                         [b1, b0], (torch.int8, torch.int16))
    if not 1 <= h <= MAX_H:
        raise ValueError(f"kmm2_gemm_planes: digits fit s8 only for "
                         f"1 <= h <= {MAX_H}, got h={h}")
    if a1.device.type == "cpu":
        return ref_kmm2_planes(a1, a0, b1, b0, h,
                               combine_int32=combine_int32)
    path = route(a1.dtype, h)
    out = staged_pipe.launch("kmm2" if path == "s8" else "kmm2_split",
                             a1, a0, b1, b0, h=h,
                             combine_int32=combine_int32, b_kmajor=k_major)
    if out.numel():    # an empty output launches nothing
        launches[f"kmm2_gemm_planes_{path}"] += 1
    return out
