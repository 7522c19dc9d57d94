"""Mamba (selective SSM) block for serving and training (port of
``repro.models.ssm``): jamba's recurrent layer.

The in / x / dt / out projections ride the quantized KMM path; the causal
depthwise conv, SiLU and softplus are elementwise ATen ops in the
reference's order and dtypes; the recurrence ``h_t = exp(delta_t A)
h_{t-1} + delta_t B_t x_t``, its read-out ``y_t = C_t h_t + D x_t`` and the
SiLU gate run in fp32 in :func:`repro_torch.kernels.ssm_scan.ssm_scan` —
the hand-written CUDA kernel on CUDA tensors, its plain version on the
CPU.  Where the reference scans associatively (prefill) or updates once
(decode), the port runs one sequential recurrence for both, so chunked
prefill, a single shot and decode compute the same state bit for bit.

The carried state is ``{"conv": (B, conv_width - 1, d_inner) in the compute
dtype, "ssm": (B, d_inner, d_state) fp32}``; both are updated in place and
returned, as the port's attention writes its K/V cache.  Training's
:func:`mamba_apply` runs the same inputs from a zero conv tail through
:func:`repro_torch.kernels.ssm_scan.ssm_scan_train` (zero state, no mask,
a backward kernel) and writes no state.

Under a mesh the block runs channel-parallel over ``model``: ``in_proj``
returns the whole ``xz`` on every rank (the GEMM gathers its N), and where
the ``conv`` / ``ssm`` state handed in holds a block of ``d_inner`` (the
pool's ``model`` block, ``dist.sharding.CACHE_MODEL_AXES``) each model rank
runs the depthwise conv on its channels, with its columns of ``conv_w`` /
``conv_b`` and its own conv tail.  ``x_proj`` contracts over the whole
``d_inner`` and quantizes its activation per row over all of K, so the
conv's output is all-gathered over ``model`` first and the codes are the
unsharded ones.  The rank then scans its channels of ``delta``, ``z``,
``a_log``, ``d_skip`` on its ``ssm`` block (B and C whole), and the
outputs are all-gathered before ``out_proj``.  Training does the same on
the ambient mesh's block where ``model`` divides ``d_inner``
(``models.layers.train_block``); the cut tensors' gradients are summed
over ``model`` (``models.layers.replicated``), so the replicated leaves get
whole gradients on every rank.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_train
from repro_torch.models import layers as L
from repro_torch.models.layers import _normal
from repro_torch.quant.qmatmul import maybe_quantized_matmul

Params = Dict[str, torch.Tensor]


def _dt_rank(d_model: int) -> int:
    return max(1, -(-d_model // 16))


def mamba_init(gen: torch.Generator, cfg, dtype, device) -> Params:
    """The reference's leaves in its order; the matrices drawn from
    ``gen`` in that order."""
    d = cfg.d_model
    di = cfg.expand * d
    ds, cw = cfg.d_state, cfg.conv_width
    dtr = _dt_rank(d)
    f32 = torch.float32
    a = torch.arange(1, ds + 1, dtype=f32, device=device)
    return {
        "in_proj": _normal(gen, (d, 2 * di), d ** -0.5, dtype, device),
        "conv_w": _normal(gen, (cw, di), cw ** -0.5, dtype, device),
        "conv_b": torch.zeros((di,), dtype=dtype, device=device),
        "x_proj": _normal(gen, (di, dtr + 2 * ds), di ** -0.5, dtype,
                          device),
        "dt_proj": _normal(gen, (dtr, di), dtr ** -0.5, dtype, device),
        "dt_bias": torch.zeros((di,), dtype=f32, device=device),
        "a_log": torch.log(a.repeat(di, 1)),
        "d_skip": torch.ones((di,), dtype=f32, device=device),
        "out_proj": _normal(gen, (di, d), di ** -0.5, dtype, device),
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` as jnp computes it.  The
    ``maximum`` (not ``clamp_min``) gives autograd jnp's slope at x = 0,
    1/2 (a tie splits the gradient; ``abs`` adds 0 there): a w=8
    ``dt_proj`` over dt_rank inputs can return exactly 0."""
    return torch.maximum(x, x.new_zeros(())) + torch.log1p(
        torch.exp(-x.abs()))


def _causal_conv(x_padded: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal 1D conv; x_padded (B, S + cw - 1, di), w (cw, di).
    The taps are added in the reference's order from zeros of x's dtype,
    so a bf16 window times the fp32 weight gives fp32."""
    cw = w.shape[0]
    s = x_padded.shape[1] - (cw - 1)
    out = torch.zeros_like(x_padded[:, cw - 1:, :])
    for i in range(cw):
        out = out + x_padded[:, i:i + s, :] * w[i][None, None, :]
    return out + b[None, None, :]


def _ssm_inputs(p: Params, x: torch.Tensor, cfg, quant, name: str,
                conv_tail: torch.Tensor,
                mask: Optional[torch.Tensor] = None):
    """Projections and the causal conv from the carried conv tail, on the
    tail's channels (this model rank's block of ``d_inner`` under a mesh,
    else all of them); returns (x_conv, z, delta, b, c, a, d_skip, x_in)
    in the reference's dtypes: x_conv, delta, b, c fp32, z and x_in in x's
    dtype (``x_in`` is the masked pre-conv projection the next conv tail
    is cut from), each of x_conv, z, delta, a, d_skip, x_in on the
    channels, b and c whole."""
    di = cfg.expand * cfg.d_model
    ds = cfg.d_state
    dtr = _dt_rank(cfg.d_model)
    dl = conv_tail.shape[-1]
    cut = dl != di
    c0 = L.block_start(dl) if cut else 0
    rep = L.replicated if cut else (lambda t: t)
    xz = rep(maybe_quantized_matmul(x, p["in_proj"], quant,
                                    f"{name}.in_proj"))
    x_in, z = xz[..., c0:c0 + dl], xz[..., di + c0:di + c0 + dl]
    if mask is not None:
        x_in = torch.where(mask.bool()[:, :, None], x_in,
                           torch.zeros_like(x_in))
    x_pad = torch.cat([conv_tail.to(x_in.dtype), x_in], dim=1)
    x_conv = F.silu(_causal_conv(x_pad, rep(p["conv_w"])[:, c0:c0 + dl],
                                 rep(p["conv_b"])[c0:c0 + dl]))
    x_dbl = maybe_quantized_matmul(L._all_heads(x_conv, cut), p["x_proj"],
                                   quant, f"{name}.x_proj")
    dt_r = x_dbl[..., :dtr]
    b_mat = rep(x_dbl[..., dtr:dtr + ds].to(torch.float32))
    c_mat = rep(x_dbl[..., dtr + ds:].to(torch.float32))
    delta = maybe_quantized_matmul(dt_r, p["dt_proj"], quant,
                                   f"{name}.dt_proj")
    delta = rep(_softplus(delta.to(torch.float32) + p["dt_bias"]))
    a = -torch.exp(rep(p["a_log"])[c0:c0 + dl])
    return (x_conv, z, delta[..., c0:c0 + dl], b_mat, c_mat, a,
            rep(p["d_skip"])[c0:c0 + dl], x_in)


def _out(p: Params, y: torch.Tensor, x: torch.Tensor, cfg, quant,
         name: str) -> torch.Tensor:
    """The scan's output on this rank's channels, all-gathered over
    ``model`` where they are a block, through ``out_proj``."""
    y = L._all_heads(y, y.shape[-1] != cfg.expand * cfg.d_model)
    return maybe_quantized_matmul(y.to(x.dtype), p["out_proj"], quant,
                                  f"{name}.out_proj")


def mamba_apply_stateful(p: Params, x: torch.Tensor, cache: Params, cfg,
                         quant, name: str,
                         mask: Optional[torch.Tensor] = None,
                         last_idx: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, Params]:
    """Sequence forward from the carried (conv, ssm) state, which is
    updated in place to the state after the last position and returned.

    Ragged prompts: ``mask`` (B, S) freezes the recurrence on pad positions
    and zeroes their conv inputs, and ``last_idx`` (B,) makes the carried
    conv tail end at each row's last real token, so the state matches a
    per-row unpadded run.  The tail is sliced from the concatenation of the
    incoming tail and this chunk's masked pre-conv inputs, so a window
    reaching below the chunk start picks up the previous chunk's inputs
    (zeros at sequence start): chunk boundaries anywhere stay exact."""
    b, s, _ = x.shape
    cw = cfg.conv_width
    x_conv, z, delta, b_mat, c_mat, a, d_skip, x_in = _ssm_inputs(
        p, x, cfg, quant, name, cache["conv"], mask=mask)
    y = ssm_scan(x_conv.to(torch.float32), delta, b_mat, c_mat, z, a,
                 d_skip, cache["ssm"],
                 mask=None if mask is None else mask.bool())
    out = _out(p, y, x, cfg, quant, name)
    full = torch.cat([cache["conv"].to(x_in.dtype), x_in], dim=1)
    if last_idx is None:
        tail = full[:, s:, :]
    else:
        # the window ends at x_in[last_idx] == full[cw - 1 + last_idx]
        idx = (last_idx.to(torch.int64)[:, None] + 1
               + torch.arange(cw - 1, device=x.device)[None, :])
        tail = torch.gather(full, 1, idx[:, :, None].expand(
            b, cw - 1, full.shape[2]))
    cache["conv"].copy_(tail)
    return out, cache


def mamba_apply(p: Params, x: torch.Tensor, cfg, quant, name: str
                ) -> torch.Tensor:
    """Full-sequence forward (train): a zero conv tail and a zero state,
    differentiable through the scan kernel's backward; under a mesh on the
    ``model`` axis's block of ``d_inner`` where it divides."""
    b = x.shape[0]
    tail = x.new_zeros((b, cfg.conv_width - 1,
                        L.train_block(cfg.expand * cfg.d_model)))
    x_conv, z, delta, b_mat, c_mat, a, d_skip, _ = _ssm_inputs(
        p, x, cfg, quant, name, tail)
    y = ssm_scan_train(x_conv.to(torch.float32), delta, b_mat, c_mat, z, a,
                       d_skip)
    return _out(p, y, x, cfg, quant, name)


def mamba_cache_init(cfg, batch: int, dtype, *, device) -> Params:
    di = cfg.expand * cfg.d_model
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, di), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, di, cfg.d_state), dtype=torch.float32,
                           device=device),
    }


def mamba_decode(p: Params, x: torch.Tensor, cache: Params, cfg, quant,
                 name: str) -> Tuple[torch.Tensor, Params]:
    """Single-token step: x (B, 1, d).  The step the reference takes — the
    window of the conv tail and this token, one state update — as the
    stateful forward's S = 1 case: the same conv taps in the same order
    and the same scan launch, so the state after prefill-then-decode is
    the state a longer prefill gives."""
    return mamba_apply_stateful(p, x, cache, cfg, quant, name)
