"""Fused single-pass integer GEMM (modes mm1 and kmm2): wrapper, plain
PyTorch version and launch counts.

Port of ``repro.kernels.fused_gemm.fused_gemm``.  On a CUDA tensor
:func:`fused_gemm` launches the hand-written Hopper kernel
(``csrc/fused_gemm.cu``) or raises; on CPU tensors it runs
:func:`fused_gemm_reference`, the plain PyTorch version of the same function.
There is no other route and no fallback.

Numerics are the reference's, bit for bit: the centered digit split at
``h = ceil(w/2)`` with ``z = 2^(h-1)``, the padded contraction length
``kp = ceil(K / block_k) * block_k`` (padding positions split as (0, -z) and
``kp`` enters the Section IV-D correction), and the fp32 operation order of
the Fig. 9 combine, correction and dequant epilogue.  Of the reference's
tile arguments only ``block_k`` is taken, because it fixes ``kp``; the CUDA
kernel picks its own tiles.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional

import torch

from repro_torch.kernels import build

MODES = ("mm1", "kmm2", "mm2", "kmm4")
PORTED_MODES = ("mm1", "kmm2")

# Launches of the CUDA kernel per mode; the wrapper adds one where it
# launches and nowhere else (CPU calls run the plain version and count 0).
launches: Dict[str, int] = {mode: 0 for mode in PORTED_MODES}

_MODE_ID = {"mm1": 1, "kmm2": 2}
_OUT_KIND = {torch.int32: 0, torch.float32: 1, torch.bfloat16: 2}


def reset_launches() -> None:
    for mode in launches:
        launches[mode] = 0


def resolve(w: int, m: int = 8, mode: str = "auto"):
    """(mode, h, z, carrier dtype) for a w-bit GEMM, as the reference's
    ``_resolve``: int8 carrier in the MM1 window, int16 through w = 16."""
    if mode == "auto":
        mode = "mm1" if w <= m else "kmm2"
    if mode not in MODES:
        raise ValueError(f"unknown fused mode {mode!r}; choices {MODES}")
    if mode not in PORTED_MODES:
        raise NotImplementedError(
            f"fused mode {mode!r} is not ported yet (ROADMAP: TPU kernel "
            f"rows 1c/1d, modes mm2 and kmm4 of the fused kernel)")
    if mode == "kmm2" and not m < w <= 14:
        raise ValueError(f"kmm2 digits fit s8 only for {m} < w <= 14, "
                         f"got w={w}")
    split = mode != "mm1"
    h = -(-w // 2) if split else 0
    z = (1 << (h - 1)) if split else 0
    carrier = torch.int16 if split else torch.int8
    return mode, h, z, carrier


def padded_k(k: int, block_k: int) -> int:
    return -(-k // block_k) * block_k


def _out_dtype(mode: str, dequant: bool, combine_int32: bool, out_dtype):
    if out_dtype is None:
        out_dtype = (torch.float32 if dequant else
                     torch.int32 if (combine_int32 or mode == "mm1") else
                     torch.float32)
    if out_dtype not in _OUT_KIND:
        raise ValueError(f"unsupported out_dtype {out_dtype}")
    int_val = mode == "mm1" or combine_int32
    if out_dtype == torch.int32 and (dequant or not int_val):
        raise ValueError("int32 output needs an exact integer plan without "
                         "dequant")
    return out_dtype


def fused_gemm(a: torch.Tensor, b: torch.Tensor,
               sx: Optional[torch.Tensor] = None,
               sw: Optional[torch.Tensor] = None, *,
               w: int, m: int = 8, mode: str = "auto", block_k: int = 256,
               combine_int32: bool = False, out_dtype=None) -> torch.Tensor:
    """Fused integer GEMM on the original (M, K) x (K, N) operands.

    ``a``/``b`` hold signed ``w``-bit values in any integer dtype (cast to
    the mode's carrier); with ``sx`` (M, 1) and ``sw`` (1, N) fp32 scales the
    dequant epilogue ``acc * (sx * sw)`` runs in the kernel.  Without scales
    the output is int32 for exact plans, fp32 otherwise.
    """
    if (sx is None) != (sw is None):
        raise ValueError("pass both sx and sw for the dequant epilogue")
    dequant = sx is not None
    mode, h, z, carrier = resolve(w, m, mode)
    out_dtype = _out_dtype(mode, dequant, combine_int32, out_dtype)
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"need (M, K) x (K, N) operands, got "
                         f"{tuple(a.shape)} x {tuple(b.shape)}")
    if a.dtype.is_floating_point or b.dtype.is_floating_point:
        raise TypeError("fused_gemm takes integer operands")
    m_dim, k_dim = a.shape
    n_dim = b.shape[1]
    kp = padded_k(k_dim, block_k)
    tensors = [a, b] + ([sx, sw] if dequant else [])
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"operands on different devices: {devices}")
    device = devices.pop()
    if dequant:
        sx = sx.to(torch.float32).reshape(m_dim, 1)
        sw = sw.to(torch.float32).reshape(1, n_dim)
    a = a.to(carrier)
    b = b.to(carrier)
    if device.type == "cpu":
        return fused_gemm_reference(
            a, b, sx, sw, mode=mode, h=h, z=z, kp=kp,
            combine_int32=combine_int32, out_dtype=out_dtype)
    if device.type != "cuda":
        raise ValueError(f"fused_gemm runs on cuda or cpu, not {device}")
    return _launch(a, b, sx, sw, mode=mode, h=h, z=z, kp=kp,
                   combine_int32=combine_int32, out_dtype=out_dtype)


def _launch(a, b, sx, sw, *, mode, h, z, kp, combine_int32, out_dtype):
    for name, t in (("a", a), ("b", b), ("sx", sx), ("sw", sw)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"fused_gemm: {name} must be contiguous "
                             f"(got strides {t.stride()})")
    m_dim, k_dim = a.shape
    n_dim = b.shape[1]
    if max(m_dim, k_dim, n_dim, kp) >= 2 ** 31:
        raise ValueError("fused_gemm: dimensions must fit int32")
    out = torch.empty((m_dim, n_dim), dtype=out_dtype, device=a.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = _kernel()(
            a.data_ptr(), b.data_ptr(),
            sx.data_ptr() if sx is not None else None,
            sw.data_ptr() if sw is not None else None,
            out.data_ptr(), m_dim, k_dim, n_dim, kp, _MODE_ID[mode], h, z,
            int(combine_int32), _OUT_KIND[out_dtype], stream)
    if err != 0:
        raise RuntimeError(f"fused_gemm kernel launch failed: CUDA error "
                           f"{err}")
    launches[mode] += 1
    return out


@functools.cache
def _kernel():
    """The C entry point of the built library, with its signature."""
    fn = build.load("fused_gemm").fused_gemm_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
                   + [ctypes.c_void_p])
    return fn


def fused_gemm_reference(a: torch.Tensor, b: torch.Tensor,
                         sx: Optional[torch.Tensor],
                         sw: Optional[torch.Tensor], *, mode: str, h: int,
                         z: int, kp: int, combine_int32: bool,
                         out_dtype) -> torch.Tensor:
    """Plain PyTorch version of the kernel (any device).

    Digit products run as float64 matmuls, which are exact here: every
    partial sum is an integer below K * 2^14 << 2^53.  The epilogue repeats
    the kernel's fp32 operation order one rounded op at a time.
    """
    k_dim = a.shape[1]
    a = a.to(torch.int64)
    b = b.to(torch.int64)

    def dot(x, y):
        return torch.matmul(x.to(torch.float64),
                            y.to(torch.float64)).to(torch.int64)

    if mode == "mm1":
        val = dot(a, b).to(torch.int32)
        is_int = True
    else:
        pad = kp - k_dim
        if pad:
            a = torch.nn.functional.pad(a, (0, pad))
            b = torch.nn.functional.pad(b, (0, 0, 0, pad))
        mask = (1 << h) - 1
        a1, a0 = a >> h, (a & mask) - z
        b1, b0 = b >> h, (b & mask) - z
        c1 = dot(a1, b1).to(torch.int32)
        cs = dot(a1 + a0, b1 + b0).to(torch.int32)
        c0 = dot(a0, b0).to(torch.int32)
        row = a.sum(dim=1, keepdim=True).to(torch.int32) - kp * z
        col = b.sum(dim=0, keepdim=True).to(torch.int32) - kp * z
        if combine_int32:
            c1, cs, c0 = c1.to(torch.int64), cs.to(torch.int64), \
                c0.to(torch.int64)
            core = (c1 << (2 * h)) + ((cs - c1 - c0) << h) + c0
            val = core + (z * row.to(torch.int64) + z * col.to(torch.int64)
                          + z * z * kp)
            val = _wrap_int32(val)
            is_int = True
        else:
            f32 = torch.float32
            c1f, c0f = c1.to(f32), c0.to(f32)
            mid = (cs.to(f32) - c1f) - c0f
            core = (c1f * float(2 ** (2 * h)) + mid * float(2 ** h)) + c0f
            corr = ((row.to(f32) * float(z) + col.to(f32) * float(z))
                    + float(z) * float(z) * float(kp))
            val = core + corr
            is_int = False
    if sx is not None:
        val = val.to(torch.float32) * (sx * sw)
        is_int = False
    if out_dtype == torch.int32:
        return val
    return val.to(out_dtype)


def _wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 modulo 2^32 (the int32 ring the kernel computes in)."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)
