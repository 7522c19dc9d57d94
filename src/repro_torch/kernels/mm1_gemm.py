"""MM1 int8 GEMM, the staged single-pass baseline for w <= m = 8 (port of
``repro.kernels.mm1_gemm``).

On CUDA tensors :func:`mm1_gemm` launches the hand-written Hopper kernel
(``csrc/staged_pipe.cu``, layout mm1) or raises; on CPU tensors it runs the
plain version, :func:`repro_torch.kernels.ref.ref_int_gemm`.  B is the
reference's contiguous (K, N) or K-major (``t.t()`` of a contiguous (N, K)
tensor); anything else raises.  Of the reference's arguments the tile
sizes and ``interpret`` are gone: the kernel picks its own tiles and
split-K plan and takes any M, K, N.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import staged_pipe
from repro_torch.kernels.ref import ref_int_gemm

# Launches of the CUDA kernel; the wrapper adds one where it launches and
# nowhere else (CPU calls run the plain version and count 0).
launches: Dict[str, int] = {"mm1_gemm": 0}


def reset_launches() -> None:
    launches["mm1_gemm"] = 0


def mm1_gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 (M, K) @ (K, N) -> int32, exact (int32 accumulation)."""
    k_major = staged_pipe.check_operands("mm1_gemm", [a], [b],
                                         (torch.int8,))
    if a.device.type == "cpu":
        return ref_int_gemm(a, b)
    out = staged_pipe.launch("mm1", a, None, b, None, h=0,
                             combine_int32=True, b_kmajor=k_major)
    if out.numel():    # an empty output launches nothing
        launches["mm1_gemm"] += 1
    return out
