"""Binding of ``csrc/staged_pipe.cu``: the one C entry point behind the
staged MM1, KMM2 and MM2 wrappers (``mm1_gemm``,
``kmm_gemm.kmm2_gemm_planes``, ``mm2_gemm.mm2_gemm_planes``), and the
operand checks they share.

The kernel takes B's planes row-major (the reference's contiguous (K, N))
or K-major (each ``t.t()`` of a contiguous (N, K) tensor, as the tied
``lm_head``'s codes and the planes ``ops`` builds from them arrive); the
wrappers tell the two apart with :func:`check_operands`.  The
tile and split-K plan is :func:`repro_torch.kernels.mm1_plan.plan_staged`;
the split-K workspace and counters are the fused kernels' own, one pair per
(device, stream) (``fused_gemm._workspace``).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.kernels import build, mm1_plan
from repro_torch.kernels.fused_gemm import _ptr, _sm_count, _workspace

# Layout ids of staged_pipe.cu's entry point.
LAYOUTS = {"mm1": 1, "kmm2": 2, "kmm2_split": 3, "mm2": 4}


def check_operands(name: str, a_planes: Sequence[torch.Tensor],
                   b_planes: Sequence[torch.Tensor], dtypes) -> bool:
    """(M, K) A planes and (K, N) B planes of one integer dtype out of
    ``dtypes``, all on one device, the CPU or a CUDA card.  A planes are
    contiguous (row-major); B planes all row-major, or all K-major (each
    ``t.t()`` of a contiguous (N, K) tensor).  The plain version would take any strides; the contract is
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
    k_major = all(t.t().is_contiguous() for t in b_planes)
    if not (row_major or k_major):
        raise ValueError(f"{name}: B planes must all be contiguous or "
                         f"K-major (got strides "
                         f"{[t.stride() for t in b_planes]})")
    devices = {t.device for t in planes}
    if len(devices) != 1 or devices.pop().type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: planes on one cpu or cuda device, got "
                         f"{[t.device for t in planes]}")
    return not row_major


def _aligned(planes, row_len: int) -> int:
    """1 where every row of every plane starts on 16 bytes."""
    return int(row_len % 16 == 0
               and all(t.data_ptr() % 16 == 0 for t in planes))


def launch(layout: str, a1: torch.Tensor, a0: Optional[torch.Tensor],
           b1: torch.Tensor, b0: Optional[torch.Tensor], *, h: int,
           combine_int32: bool, b_kmajor: bool,
           split: Optional[int] = None) -> torch.Tensor:
    """One launch of the CUDA kernel on CUDA operands that passed
    :func:`check_operands`: int32 out for mm1 and the int32
    combine, float32 for the fp32 combine.  ``split`` forces the split-K
    count (the plan's rule by default)."""
    m_dim, k_dim = a1.shape
    n_dim = b1.shape[1]
    if max(m_dim, k_dim, n_dim) >= 2 ** 31:
        raise ValueError("staged_pipe: dimensions must fit int32")
    int_out = combine_int32 or layout == "mm1"
    out = torch.empty((m_dim, n_dim), device=a1.device,
                      dtype=torch.int32 if int_out else torch.float32)
    if out.numel() == 0:
        return out
    nbytes = a1.element_size()
    pl = mm1_plan.plan_staged(layout, m_dim, k_dim, n_dim,
                              _sm_count(a1.device.index), nbytes, split)
    a_planes = [t for t in (a1, a0) if t is not None]
    b_planes = [t for t in (b1, b0) if t is not None]
    vec_a = _aligned(a_planes, k_dim * nbytes)
    vec_b = _aligned(b_planes, (k_dim if b_kmajor else n_dim) * nbytes)
    fn = build.entry("staged_pipe", "staged_pipe_launch", 7, 13)
    with torch.cuda.device(a1.device):
        stream = torch.cuda.current_stream(a1.device).cuda_stream
        ws, counters = _workspace(a1.device, stream, pl)
        err = fn(a1.data_ptr(), _ptr(a0), b1.data_ptr(), _ptr(b0),
                 out.data_ptr(), _ptr(ws), _ptr(counters), m_dim, k_dim,
                 n_dim, LAYOUTS[layout], nbytes, int(b_kmajor), h,
                 int(combine_int32), pl.bm, pl.split, pl.k_split, vec_a,
                 vec_b, stream)
    if err != 0:
        raise RuntimeError(f"staged_pipe {layout} launch failed: CUDA error "
                           f"{err}")
    return out
