"""The one symmetric quantizer every integer path shares (port of
``repro.quant.quantize``):

    qmax  = 2**(bits-1) - 1
    amax  = max(|x|) over ``axis`` (fp32)
    scale = max(amax, 1e-8) / qmax          (fp32)
    q     = clip(round(x / scale), -qmax, qmax)

``torch.round`` rounds half to even, as ``jnp.round`` does, and the fp32
order is the reference's: ``x / scale``, then round, then clip.  Both
divisions are tensor by tensor: PyTorch's CUDA division by a Python scalar
multiplies by its reciprocal, which can differ in the last bit.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def carrier_dtype(w: int, m: int = 8) -> torch.dtype:
    """The integer dtype w-bit codes are stored in: int8 in the MM1 window
    (w <= m), int16 through w = 16, int32 above."""
    return torch.int8 if w <= m else torch.int16 if w <= 16 else torch.int32


def quantize_symmetric(x: torch.Tensor, bits: int, axis=None,
                       keepdims: Optional[bool] = None,
                       storage_dtype=torch.int32
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric signed ``bits``-bit quantization. Returns (q, scale_f32)."""
    if keepdims is None:
        keepdims = axis is not None
    xf = x.to(torch.float32)
    qmax = float(2 ** (bits - 1) - 1)
    if axis is None:
        amax = xf.abs().amax()
        if keepdims:
            amax = amax.reshape((1,) * xf.dim())
    else:
        amax = xf.abs().amax(dim=axis, keepdim=keepdims)
    scale = amax.clamp_min(1e-8) / torch.full_like(amax, qmax)
    q = torch.round(xf / scale).clamp(-qmax, qmax).to(storage_dtype)
    return q, scale
