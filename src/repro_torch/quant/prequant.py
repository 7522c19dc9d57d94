"""Pre-quantized weight storage for serving (port of
``repro.quant.prequant``).

The per-call quantized path re-quantizes every weight from full precision
on every call.  ``prequantize`` rewrites the parameter tree once: every
quantizable weight leaf becomes ``{"q": intN codes, "scale": fp32
per-channel scale}``, with the codes in the narrowest carrier
(:func:`storage_dtype`: int8 through w = 8, int16 above).
``maybe_quantized_matmul`` and ``maybe_quantized_batched`` recognize the
record and hand its codes and scale straight to the kernel
(:func:`repro_torch.quant.qmatmul.prequant_matmul`).

The rounding is :func:`repro_torch.quant.quantize.quantize_symmetric`'s,
along the contraction axis ``ndim - 2``: a 2-D (K, N) leaf gets a scale per
output channel, and period-stacked (P, K, N) and (P, E, K, N) leaves a
scale per (period[, expert], channel) — the scale the per-call path computes
on each period's slice, so through w = 16 a prequantized run is the per-call
run, bit for bit.  For the same reason a stack of per-period records is
the record of the stacked leaf, which ``models.lm.init_params(...,
prequant=)`` relies on to build the records leaf by leaf.

Above w = 16 the reference stores the codes in int16 too, and XLA's
float -> int16 conversion saturates.  PyTorch's wraps, so the codes are
clamped to int16's range before the cast: the records equal the
reference's, and, as there, they are not the per-call path's codes.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.quant.quantize import quantize_symmetric

Params = Any

# Weight-leaf names that feed quantized matmuls (the reference's set).  The
# MoE router is not among them, and a tied lm_head is ``embed.T``, not a
# leaf: both stay on the per-call path.
_QUANT_LEAVES = {
    "wq", "wk", "wv", "wo", "wi", "wg", "wr", "w1", "w2",
    "in_proj", "out_proj", "x_proj", "dt_proj", "lm_head",
}


def storage_dtype(bits: int) -> torch.dtype:
    """Narrowest integer carrier for ``bits``-bit prequantized storage."""
    return torch.int8 if bits <= 8 else torch.int16


def is_weight_leaf(name: str, ndim: int) -> bool:
    """Whether a leaf named ``name`` of ``ndim`` axes becomes a record."""
    return name in _QUANT_LEAVES and ndim >= 2


# Output channels quantized at a time: every channel has its own scale, so
# the record is the same, and the temporaries are a chunk's, not the leaf's
# (an untied lm_head of 6144 x 256000 is 6.3 GB in fp32).  For the same
# reason a leaf with a batch axis (experts, periods) of more than
# RECORD_ELEMS elements is quantized one index of its first axis at a time
# (jamba's 16 experts of 4096 x 14336 are 3.76 GB in fp32 a leaf).
RECORD_COLUMNS = 16384
RECORD_ELEMS = 2 ** 28


def record(leaf: torch.Tensor, bits: int) -> dict:
    """The {"q", "scale"} record of one weight leaf, quantized
    ``RECORD_COLUMNS`` output channels (last axis), and for a large leaf
    with batch axes one index of the first axis, at a time."""
    dtype = storage_dtype(bits)
    info = torch.iinfo(dtype)
    by_index = leaf.dim() > 2 and leaf.numel() > RECORD_ELEMS
    if by_index or leaf.shape[-1] > RECORD_COLUMNS:
        q = torch.empty(leaf.shape, dtype=dtype, device=leaf.device)
        scale = torch.empty(leaf.shape[:-2] + (1, leaf.shape[-1]),
                            dtype=torch.float32, device=leaf.device)
        if by_index:
            for i in range(leaf.shape[0]):
                part = record(leaf[i], bits)
                q[i], scale[i] = part["q"], part["scale"]
            return {"q": q, "scale": scale}
        for c in range(0, leaf.shape[-1], RECORD_COLUMNS):
            part = record(leaf[..., c:c + RECORD_COLUMNS], bits)
            q[..., c:c + RECORD_COLUMNS] = part["q"]
            scale[..., c:c + RECORD_COLUMNS] = part["scale"]
        return {"q": q, "scale": scale}
    q, scale = quantize_symmetric(leaf, bits, axis=leaf.dim() - 2,
                                  keepdims=True, storage_dtype=torch.float32)
    return {"q": q.clamp_(info.min, info.max).to(dtype), "scale": scale}


def prequantize(params: Params, quant) -> Params:
    """Replace the quantizable weight leaves with {"q", "scale"} records;
    bits come from ``quant.bits_for`` of the leaf's dotted tree path.
    Other leaves are the input's tensors, not copies."""

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        if not is_weight_leaf(path[-1], tree.dim()):
            return tree
        return record(tree, quant.bits_for(".".join(path)))

    return walk(params, ())


def is_prequantized(wmat) -> bool:
    return isinstance(wmat, dict) and "q" in wmat and "scale" in wmat
