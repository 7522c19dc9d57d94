"""Binding of ``csrc/staged_gemm.cu``: the shared operand checks and the one
C entry point behind the staged kernels' wrappers (``mm1_gemm``,
``kmm_gemm.kmm2_gemm_planes``, ``mm2_gemm.mm2_gemm_planes``)."""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.kernels import build

# Layout ids of staged_gemm.cu's entry point.
LAYOUTS = {"mm1": 1, "kmm2": 2, "kmm2_split": 3, "mm2": 4}


def check_operands(name: str, a_planes: Sequence[torch.Tensor],
                   b_planes: Sequence[torch.Tensor], dtypes) -> None:
    """(M, K) A planes and (K, N) B planes of one integer dtype out of
    ``dtypes``, contiguous, all on one device, the CPU or a CUDA card (the
    plain version would take any strides; the contract is the kernel's on
    both devices)."""
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
    for i, t in enumerate(planes):
        if not t.is_contiguous():
            raise ValueError(f"{name}: plane {i} must be contiguous (got "
                             f"strides {t.stride()})")
    devices = {t.device for t in planes}
    if len(devices) != 1 or devices.pop().type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: planes on one cpu or cuda device, got "
                         f"{[t.device for t in planes]}")


def launch(layout: str, a1: torch.Tensor, a0: Optional[torch.Tensor],
           b1: torch.Tensor, b0: Optional[torch.Tensor], *, h: int,
           combine_int32: bool) -> torch.Tensor:
    """One launch of the CUDA kernel on CUDA operands that passed
    :func:`check_operands`: int32 out
    for mm1 and the int32 combine, float32 for the fp32 combine."""
    m_dim, k_dim = a1.shape
    n_dim = b1.shape[1]
    if max(m_dim, k_dim, n_dim) >= 2 ** 31:
        raise ValueError("staged_gemm: dimensions must fit int32")
    int_out = combine_int32 or layout == "mm1"
    out = torch.empty((m_dim, n_dim), device=a1.device,
                      dtype=torch.int32 if int_out else torch.float32)
    if out.numel() == 0:
        return out
    ptr = (lambda t: t.data_ptr() if t is not None else None)  # noqa: E731
    fn = build.entry("staged_gemm", "staged_gemm_launch", 5, 7)
    with torch.cuda.device(a1.device):
        stream = torch.cuda.current_stream(a1.device).cuda_stream
        err = fn(a1.data_ptr(), ptr(a0), b1.data_ptr(), ptr(b0),
                 out.data_ptr(), m_dim, k_dim, n_dim, LAYOUTS[layout],
                 a1.element_size(), h, int(combine_int32), stream)
    if err != 0:
        raise RuntimeError(f"staged_gemm {layout} launch failed: CUDA error "
                           f"{err}")
    return out
