"""Row-invariant fp32 matmul and row norms (``csrc/rowinv.cu``).

The reference's chunked prefill is bit-exact against a single-shot
prefill: a row of every op is computed the same way whatever the number
of rows.  On the card ATen's fp32 matmul and its row reductions pick
their algorithm by the row count, so two wrappers route those ops through
a hand-written kernel whose reduction order depends on the reduced length
only:

  * :func:`rowinv_matmul` — fp32 (..., K) @ (K, N) (RWKV-6's decay LoRA
    products);
  * :func:`rowinv_norm` — LayerNorm with bias (``kind="ln"``) or RMSNorm
    over the last axis, in fp32, cast back to the input dtype (every norm
    of every model).

On CUDA tensors each launches its kernel or raises; on CPU tensors it runs
its plain version, which is exactly the ATen expression the models used
before (so every CPU parity test against JAX is unchanged).  The kernels
agree with the plain versions to fp32 rounding (their sums run in another
order), not bit for bit.

Training.  Where autograd records, each runs as a
``torch.autograd.Function``: the forward as above (the kernel's output,
filled through ctypes, has no ``grad_fn`` of its own) and the backward in
fp32 ATen ops on the saved inputs, as XLA's autodiff of the reference's
jnp ops is plain XLA ops: the norm's VJP (:func:`rowinv_norm_vjp`) and the
matmul's two products (:func:`rowinv_matmul_vjp`).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional

import torch

from repro_torch.kernels import build, check_grad_fn, records_grad

# Launches of the CUDA kernels; a wrapper adds one where it launches and
# nowhere else (CPU calls run the plain version and count 0).
launches: Dict[str, int] = {"rowinv_matmul": 0, "rowinv_norm": 0}

# From which K the matmul kernel's four warps a block split each K sum,
# and the norm kernel's elements a thread at most (csrc/rowinv.cu's
# SPLIT_K, NORM_EPT).
SPLIT_K, NORM_EPT = 1024, 32

_NORM_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KINDS = {"rms": 0, "ln": 1}


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0


def matmul_lanes(k: int) -> int:
    """The lanes the matmul kernel splits a K sum across, fixed by K: a
    warp, or from ``SPLIT_K`` the four warps of a block."""
    return 128 if k >= SPLIT_K else 32


def norm_threads(d: int) -> int:
    """The norm kernel's threads a row, fixed by d: a warp for every 256
    elements, 1 to 8 warps."""
    return 32 * min(max(d // 256, 1), 8)


def rowinv_matmul_reference(x: torch.Tensor, w: torch.Tensor
                            ) -> torch.Tensor:
    """Plain version: ATen's matmul."""
    return x @ w


def rowinv_norm_reference(x: torch.Tensor, scale: torch.Tensor,
                          bias: Optional[torch.Tensor], kind: str,
                          eps: float) -> torch.Tensor:
    """Plain version: the reference's norm in ATen ops, in fp32 and cast
    back to the input dtype."""
    xf = x.to(torch.float32)
    if kind == "ln":
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        out = (xf - mu) * torch.rsqrt(var + eps) * scale + bias
    else:
        ms = (xf * xf).mean(-1, keepdim=True)
        out = xf * torch.rsqrt(ms + eps) * scale
    return out.to(x.dtype)


@functools.cache
def _entry(fn: str):
    func = getattr(build.load("rowinv"), fn)
    func.restype = ctypes.c_int
    p, i = ctypes.c_void_p, ctypes.c_int
    func.argtypes = ([p] * 3 + [i] * 6 + [p] if fn == "rowinv_matmul_launch"
                     else [p] * 4 + [i] * 7 + [ctypes.c_float, p])
    return func


def _rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` as (rows, last) with the last axis contiguous (a view where
    the leading axes collapse to one stride, else a copy)."""
    t2 = t.reshape(-1, t.shape[-1])
    return t2 if t2.stride(-1) == 1 else t2.contiguous()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def rowinv_matmul_vjp(g: torch.Tensor, x: torch.Tensor, w: torch.Tensor):
    """(dx, dw) of ``x @ w`` for the cotangent ``g``: ``g @ w^T`` and
    ``x^T @ g`` over the flattened rows, fp32 ATen matmuls (the reference's
    are plain jnp matmuls)."""
    f32 = torch.float32
    g2 = g.reshape(-1, g.shape[-1]).to(f32)
    x2 = x.reshape(-1, x.shape[-1]).to(f32)
    dx = (g2 @ w.to(f32).T).reshape(x.shape).to(x.dtype)
    return dx, (x2.T @ g2).to(w.dtype)


class _MatmulFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _matmul_forward(x, w)

    @staticmethod
    def backward(ctx, g):
        return rowinv_matmul_vjp(g, *ctx.saved_tensors)


def rowinv_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for x (..., K) and w (K, N): on CUDA, fp32 only, each
    output's K sum in one order fixed by K (``matmul_lanes(K)``
    interleaved lanes, a shuffle butterfly a warp, the warp sums in
    order), whatever the number of rows.  Differentiable in x and w
    (:func:`rowinv_matmul_vjp`)."""
    if not records_grad(x, w):
        return _matmul_forward(x, w)
    return check_grad_fn(_MatmulFunction.apply(x, w), "rowinv_matmul")


def _matmul_forward(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The matmul's forward: the plain version on CPU tensors, the kernel
    on CUDA ones."""
    if x.device.type == "cpu" and w.device.type == "cpu":
        return rowinv_matmul_reference(x, w)
    if x.device != w.device or x.device.type != "cuda":
        raise ValueError(f"rowinv_matmul: operands on one cpu or cuda "
                         f"device, got {x.device}, {w.device}")
    return _matmul_launch(x, w)


def _matmul_launch(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One launch of the matmul kernel on CUDA tensors."""
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError(f"rowinv_matmul: the kernel takes float32, got "
                        f"{x.dtype}, {w.dtype}")
    if w.dim() != 2 or x.dim() < 1 or x.shape[-1] != w.shape[0]:
        raise ValueError(f"rowinv_matmul: need (..., K) @ (K, N), got "
                         f"{tuple(x.shape)} @ {tuple(w.shape)}")
    k, n = w.shape
    x2 = _rows(x)
    w2 = w if w.stride(1) == 1 else w.contiguous()
    m = x2.shape[0]
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m and n:
        if max(m, k, n, x2.stride(0), w2.stride(0)) >= 2 ** 31:
            raise ValueError("rowinv_matmul: sizes and strides must fit the "
                             "kernel's int arguments")
        with torch.cuda.device(x.device):
            err = _entry("rowinv_matmul_launch")(
                x2.data_ptr(), w2.data_ptr(), y.data_ptr(), m, k, n,
                x2.stride(0), w2.stride(0), y.stride(0), _stream(x))
        _raise_on(err, "rowinv_matmul")
        launches["rowinv_matmul"] += 1
    return y.reshape(*x.shape[:-1], n)


def rowinv_norm_vjp(g: torch.Tensor, x: torch.Tensor, scale: torch.Tensor,
                    bias: Optional[torch.Tensor], kind: str, eps: float):
    """(dx, dscale, dbias) of the norm at ``x`` for the cotangent ``g``, in
    fp32 ATen ops; dx in x's dtype, dbias None for RMSNorm."""
    f32 = torch.float32
    xf, gf = x.to(f32), g.to(f32)
    if kind == "ln":
        xc = xf - xf.mean(-1, keepdim=True)
        r = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps)
    else:
        xc = xf
        r = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    n = xc * r
    gs = gf * scale
    proj = (gs * n).mean(-1, keepdim=True)
    if kind == "ln":
        dx = r * (gs - gs.mean(-1, keepdim=True) - n * proj)
    else:
        dx = r * (gs - n * proj)
    lead = tuple(range(x.dim() - 1))
    dscale = (gf * n).sum(lead)
    dbias = gf.sum(lead) if kind == "ln" else None
    return dx.to(x.dtype), dscale, dbias


class _NormFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, kind, eps):
        ctx.save_for_backward(x, scale)
        ctx.kind, ctx.eps, ctx.has_bias = kind, eps, bias is not None
        return _norm_forward(x, scale, bias, kind, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        dx, dscale, dbias = rowinv_norm_vjp(g, x, scale, None, ctx.kind,
                                            ctx.eps)
        return (dx, dscale, dbias if ctx.has_bias else None, None, None)


def rowinv_norm(x: torch.Tensor, scale: torch.Tensor,
                bias: Optional[torch.Tensor] = None, *, kind: str = "rms",
                eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm (``kind="rms"``) or LayerNorm with bias (``"ln"``) over the
    last axis in fp32, cast back to x's dtype (fp32 or bf16 on CUDA); on
    CUDA one block a row, its sums in one order fixed by the row's
    length.  Differentiable in x, scale and bias (:func:`rowinv_norm_vjp`)."""
    if kind not in _KINDS:
        raise ValueError(f"rowinv_norm: unknown kind {kind!r}")
    if kind == "ln" and bias is None:
        raise ValueError("rowinv_norm: LayerNorm needs a bias")
    if kind != "ln":
        bias = None
    if not records_grad(x, scale, bias):
        return _norm_forward(x, scale, bias, kind, eps)
    return check_grad_fn(_NormFunction.apply(x, scale, bias, kind, eps),
                         "rowinv_norm")


def _norm_forward(x, scale, bias, kind: str, eps: float) -> torch.Tensor:
    """The norm's forward: the plain version on CPU tensors, the kernel on
    CUDA ones."""
    tensors = [x, scale] + ([bias] if kind == "ln" else [])
    if all(t.device.type == "cpu" for t in tensors):
        return rowinv_norm_reference(x, scale, bias, kind, eps)
    if len({t.device for t in tensors}) != 1 or x.device.type != "cuda":
        raise ValueError(f"rowinv_norm: operands on one cpu or cuda device, "
                         f"got {[t.device for t in tensors]}")
    return _norm_launch(x, scale, bias, kind, eps)


def _norm_launch(x, scale, bias, kind: str, eps: float) -> torch.Tensor:
    """One launch of the norm kernel on CUDA tensors."""
    tensors = [x, scale] + ([bias] if kind == "ln" else [])
    if x.dtype not in _NORM_DTYPES:
        raise TypeError(f"rowinv_norm: the kernel takes float32 or bfloat16 "
                        f"rows, got {x.dtype}")
    d = x.shape[-1]
    if d > norm_threads(d) * NORM_EPT:
        raise ValueError(f"rowinv_norm: the kernel takes rows of at most "
                         f"{norm_threads(d) * NORM_EPT}, got {d}")
    params = tensors[1:]
    if any(t.dtype != torch.float32 or t.shape != (d,) or t.stride(0) != 1
           for t in params):
        raise ValueError(f"rowinv_norm: scale and bias must be contiguous "
                         f"float32 ({d},), got "
                         f"{[(t.dtype, tuple(t.shape)) for t in params]}")
    x2 = _rows(x)
    rows = x2.shape[0]
    y = torch.empty((rows, d), dtype=x.dtype, device=x.device)
    if rows and d:
        if max(rows, d, x2.stride(0)) >= 2 ** 31:
            raise ValueError("rowinv_norm: sizes and strides must fit the "
                             "kernel's int arguments")
        with torch.cuda.device(x.device):
            err = _entry("rowinv_norm_launch")(
                x2.data_ptr(), scale.data_ptr(),
                bias.data_ptr() if kind == "ln" else None, y.data_ptr(),
                rows, d, x2.stride(0), y.stride(0), _NORM_DTYPES[x.dtype],
                _KINDS[kind], norm_threads(d), eps, _stream(x))
        _raise_on(err, "rowinv_norm")
        launches["rowinv_norm"] += 1
    return y.reshape(x.shape)
