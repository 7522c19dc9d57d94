"""Binding of ``csrc/staged_gemm.cu`` (the staged MM2 kernel behind
``mm2_gemm.mm2_gemm_planes``), and the operand checks every staged wrapper
shares (``mm1_gemm``, ``kmm_gemm.kmm2_gemm_planes`` on
``csrc/staged_pipe.cu``, ``mm2_gemm_planes`` here)."""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.kernels import build

# Layout id of staged_gemm.cu's entry point.
MM2_LAYOUT = 4


def check_operands(name: str, a_planes: Sequence[torch.Tensor],
                   b_planes: Sequence[torch.Tensor], dtypes, *,
                   k_major_b: bool = True) -> bool:
    """(M, K) A planes and (K, N) B planes of one integer dtype out of
    ``dtypes``, all on one device, the CPU or a CUDA card.  A planes are
    contiguous (row-major); B planes all row-major, or, where
    ``k_major_b``, all K-major (each ``t.t()`` of a contiguous (N, K)
    tensor).  The plain version would take any strides; the contract is
    the kernel's on both devices.  Returns whether B is K-major (False
    where both layouts hold: one row or one column)."""
    planes = list(a_planes) + list(b_planes)
    a, b = a_planes[0], b_planes[0]
    if any(t.dim() != 2 for t in planes) or a.shape[1] != b.shape[0] \
            or any(t.shape != a.shape for t in a_planes) \
            or any(t.shape != b.shape for t in b_planes):
        raise ValueError(f"{name}: need (M, K) and (K, N) planes, got "
                         f"{[tuple(t.shape) for t in planes]}")
    if a.shape[1] == 0:
        raise ValueError(f"{name}: K must be positive")
    if {t.dtype for t in planes} != {planes[0].dtype} \
            or planes[0].dtype not in dtypes:
        raise TypeError(f"{name}: planes must all be one of {dtypes}, got "
                        f"{[t.dtype for t in planes]}")
    for i, t in enumerate(a_planes):
        if not t.is_contiguous():
            raise ValueError(f"{name}: A plane {i} must be contiguous (got "
                             f"strides {t.stride()})")
    row_major = all(t.is_contiguous() for t in b_planes)
    k_major = k_major_b and all(t.t().is_contiguous() for t in b_planes)
    if not (row_major or k_major):
        layouts = "contiguous or K-major" if k_major_b else "contiguous"
        raise ValueError(f"{name}: B planes must all be {layouts} (got "
                         f"strides {[t.stride() for t in b_planes]})")
    devices = {t.device for t in planes}
    if len(devices) != 1 or devices.pop().type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: planes on one cpu or cuda device, got "
                         f"{[t.device for t in planes]}")
    return not row_major


def launch_mm2(a1: torch.Tensor, a0: torch.Tensor, b1: torch.Tensor,
               b0: torch.Tensor, *, h: int,
               combine_int32: bool) -> torch.Tensor:
    """One launch of the MM2 kernel on CUDA int8 planes that passed
    :func:`check_operands` with row-major B: int32 out for the int32
    combine, float32 for the fp32 combine."""
    m_dim, k_dim = a1.shape
    n_dim = b1.shape[1]
    if max(m_dim, k_dim, n_dim) >= 2 ** 31:
        raise ValueError("staged_gemm: dimensions must fit int32")
    out = torch.empty((m_dim, n_dim), device=a1.device,
                      dtype=torch.int32 if combine_int32 else torch.float32)
    if out.numel() == 0:
        return out
    fn = build.entry("staged_gemm", "staged_gemm_launch", 5, 7)
    with torch.cuda.device(a1.device):
        stream = torch.cuda.current_stream(a1.device).cuda_stream
        err = fn(a1.data_ptr(), a0.data_ptr(), b1.data_ptr(), b0.data_ptr(),
                 out.data_ptr(), m_dim, k_dim, n_dim, MM2_LAYOUT,
                 a1.element_size(), h, int(combine_int32), stream)
    if err != 0:
        raise RuntimeError(f"staged_gemm mm2 launch failed: CUDA error "
                           f"{err}")
    return out
