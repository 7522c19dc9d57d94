"""RWKV-6 ("Finch") block for serving (port of ``repro.models.rwkv``):
attention-free linear recurrence with data-dependent per-channel decay.

Per head (state S in R^{D x D}):  S_t = diag(w_t) S_{t-1} + k_t^T v_t,
y_t = r_t (S_{t-1} + diag(u) k_t^T v_t).  The decay w_t comes from a
low-rank MLP on the token-shifted input (the v6 data-dependence).  The
r/k/v/g/o projections ride the quantized KMM path; the recurrence runs in
fp32 in :func:`repro_torch.kernels.wkv_gemm.wkv_stateful` — the
hand-written CUDA kernel on CUDA tensors, its plain version on the CPU —
for every prefill (S >= 1 steps from the carried state) and every decode
step (S = 1), where the reference scans in jnp.  The decay's LoRA products
and the norms run on the row-invariant kernels (``kernels/rowinv.py``), so
chunked prefill is bit-exact against a single shot on the card too.

The carried state is ``{"shift": (B, 1, d) in the compute dtype, "wkv":
(B, H, D, D) fp32}``; both are updated in place and returned, as the port's
attention writes its K/V cache.  ``rwkv_apply`` (training) waits for the
training item.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.rowinv import rowinv_matmul
from repro_torch.kernels.wkv_gemm import wkv_stateful
from repro_torch.models import layers as L
from repro_torch.quant.qmatmul import maybe_quantized_matmul

Params = Dict[str, torch.Tensor]

LORA_DIM = 64


def rwkv_init(gen: torch.Generator, cfg, dtype, device) -> Params:
    d = cfg.d_model
    s = d ** -0.5
    hd = cfg.rwkv_head_dim
    nh = d // hd
    f32 = torch.float32
    return {
        "mix": torch.full((5, d), 0.5, dtype=f32, device=device),  # r,k,v,g,w
        "wr": L._normal(gen, (d, d), s, dtype, device),
        "wk": L._normal(gen, (d, d), s, dtype, device),
        "wv": L._normal(gen, (d, d), s, dtype, device),
        "wg": L._normal(gen, (d, d), s, dtype, device),
        "wo": L._normal(gen, (d, d), s, dtype, device),
        "w0": torch.full((d,), -6.0, dtype=f32, device=device),  # slow decay
        "w_lora_a": L._normal(gen, (d, LORA_DIM), s, dtype, device),
        "w_lora_b": L._normal(gen, (LORA_DIM, d), LORA_DIM ** -0.5, dtype,
                              device),
        "u": L._normal(gen, (nh, hd), 0.1, f32, device),
        "ln_x": L.norm_init(d, device, kind="ln"),
    }


def _shift_mix(x: torch.Tensor, prev: torch.Tensor, mix: torch.Tensor):
    """Token shift: blend each position with its predecessor.

    x: (B, S, d); prev: (B, 1, d) state carried across calls.  Returns the
    5 mixed streams (r, k, v, g, w; fp32, as the fp32 ``mix`` promotes
    them) and the new shift state."""
    shifted = torch.cat([prev, x[:, :-1, :]], dim=1)
    mixed = [x * m + shifted * (1.0 - m) for m in mix]
    return mixed, x[:, -1:, :]


def _decay(p: Params, xw: torch.Tensor) -> torch.Tensor:
    """exp(-exp(w0 + lora(xw))) in fp32, in (0, 1); the LoRA products in
    xw's dtype (fp32: the fp32 ``mix`` promotes it), on the card through
    the row-invariant matmul kernel."""
    lora = torch.tanh(rowinv_matmul(xw, p["w_lora_a"].to(xw.dtype)))
    lora = rowinv_matmul(lora, p["w_lora_b"].to(xw.dtype))
    return torch.exp(-torch.exp(p["w0"] + lora.to(torch.float32)))


def _project(p: Params, streams, quant, name: str):
    xr, xk, xv, xg, xw = streams
    r = maybe_quantized_matmul(xr, p["wr"], quant, f"{name}.wr")
    k = maybe_quantized_matmul(xk, p["wk"], quant, f"{name}.wk")
    v = maybe_quantized_matmul(xv, p["wv"], quant, f"{name}.wv")
    g = maybe_quantized_matmul(xg, p["wg"], quant, f"{name}.wg")
    return r, k, v, g, _decay(p, xw)


def _heads(x: torch.Tensor, nh: int, hd: int) -> torch.Tensor:
    return x.reshape(*x.shape[:-1], nh, hd)


def _mix_and_project(p: Params, x: torch.Tensor, prev: torch.Tensor, cfg,
                     quant, name: str):
    """Token shift and the five projections, heads split: fp32 r, k, v, w
    (B, S, H, D), g (B, S, d) and the new shift."""
    hd = cfg.rwkv_head_dim
    nh = x.shape[-1] // hd
    streams, new_shift = _shift_mix(x, prev.to(x.dtype), p["mix"])
    r, k, v, g, w = _project(p, streams, quant, name)
    f32 = torch.float32
    return (_heads(r.to(f32), nh, hd), _heads(k.to(f32), nh, hd),
            _heads(v.to(f32), nh, hd), _heads(w, nh, hd), g, new_shift)


def _out(p: Params, y: torch.Tensor, g: torch.Tensor, x: torch.Tensor,
         quant, name: str) -> torch.Tensor:
    """ln_x over all of d_model, the SiLU gate, the output projection."""
    b, s = x.shape[:2]
    y = L.norm_apply(p["ln_x"], y.reshape(b, s, -1), kind="ln")
    y = y * F.silu(g.to(torch.float32))
    return maybe_quantized_matmul(y.to(x.dtype), p["wo"], quant,
                                  f"{name}.wo")


def rwkv_apply_stateful(p: Params, x: torch.Tensor, cache: Params, cfg,
                        quant, name: str,
                        mask: Optional[torch.Tensor] = None,
                        last_idx: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, Params]:
    """Sequence forward from the carried (shift, wkv) state, which is
    updated in place to the end state and returned.

    Ragged prompts: ``mask`` (B, S) freezes the wkv state on pad positions
    (decay forced to 1, kv contribution zeroed) and zeroes pad inputs before
    the token shift, so a shift at a pad boundary sees the zeros an unpadded
    run starts from; ``last_idx`` (B,) picks each row's last *real* token
    for the carried shift state (right-padded prompts)."""
    b = x.shape[0]
    if mask is not None:
        x = torch.where(mask.bool()[:, :, None], x, torch.zeros_like(x))
    r, k, v, w, g, new_shift = _mix_and_project(p, x, cache["shift"], cfg,
                                                quant, name)
    if mask is not None:                                   # freeze on pads
        m4 = mask.bool()[:, :, None, None]
        k = torch.where(m4, k, torch.zeros_like(k))
        w = torch.where(m4, w, torch.ones_like(w))
    if last_idx is not None:
        idx = last_idx.to(torch.int64)[:, None, None].expand(b, 1, x.shape[2])
        new_shift = torch.gather(x, 1, idx)
    y, _ = wkv_stateful(r, k, v, w, p["u"], cache["wkv"], inplace=True)
    out = _out(p, y, g, x, quant, name)
    cache["shift"].copy_(new_shift)
    return out, cache


def rwkv_cache_init(cfg, batch: int, dtype, *, device) -> Params:
    d = cfg.d_model
    hd = cfg.rwkv_head_dim
    nh = d // hd
    return {
        "shift": torch.zeros((batch, 1, d), dtype=dtype, device=device),
        "wkv": torch.zeros((batch, nh, hd, hd), dtype=torch.float32,
                           device=device),
    }


def rwkv_decode(p: Params, x: torch.Tensor, cache: Params, cfg, quant,
                name: str) -> Tuple[torch.Tensor, Params]:
    """Single-token step: x (B, 1, d); constant-size state, updated in
    place."""
    r, k, v, w, g, new_shift = _mix_and_project(p, x, cache["shift"], cfg,
                                                quant, name)
    y, _ = wkv_stateful(r, k, v, w, p["u"], cache["wkv"], inplace=True)
    out = _out(p, y, g, x, quant, name)
    cache["shift"].copy_(new_shift)
    return out, cache
