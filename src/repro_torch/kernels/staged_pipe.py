"""Binding of ``csrc/staged_pipe.cu``: the one C entry point behind the
staged MM1 and KMM2 wrappers (``mm1_gemm``, ``kmm_gemm.kmm2_gemm_planes``).

The kernel takes B's planes row-major (the reference's contiguous (K, N))
or K-major (each ``t.t()`` of a contiguous (N, K) tensor, as the tied
``lm_head``'s codes and the planes ``ops`` builds from them arrive); the
wrapper tells the two apart with
:func:`repro_torch.kernels.staged_gemm.check_operands`.  The
tile and split-K plan is :func:`repro_torch.kernels.mm1_plan.plan_staged`;
the split-K workspace and counters are the fused kernels' own, one pair per
(device, stream) (``fused_gemm._workspace``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build, mm1_plan
from repro_torch.kernels.fused_gemm import _ptr, _sm_count, _workspace

# Layout ids of staged_pipe.cu's entry point.
LAYOUTS = {"mm1": 1, "kmm2": 2, "kmm2_split": 3}


def _aligned(planes, row_len: int) -> int:
    """1 where every row of every plane starts on 16 bytes."""
    return int(row_len % 16 == 0
               and all(t.data_ptr() % 16 == 0 for t in planes))


def launch(layout: str, a1: torch.Tensor, a0: Optional[torch.Tensor],
           b1: torch.Tensor, b0: Optional[torch.Tensor], *, h: int,
           combine_int32: bool, b_kmajor: bool,
           split: Optional[int] = None) -> torch.Tensor:
    """One launch of the CUDA kernel on CUDA operands that passed
    ``staged_gemm.check_operands``: int32 out for mm1 and the int32
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
