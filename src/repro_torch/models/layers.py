"""Model building blocks (port of ``repro.models.layers``): RMSNorm and
LayerNorm, RoPE, the MLP (gated or plain), GQA attention for prefill
(chunked, against the KV cache) and one-token decode.

Plain functions on tensors and parameter dicts, in the reference's layouts:
activations (B, S, d), heads (B, S, H, D), caches (B, Smax, K, D).  Every
weight matmul goes through :func:`maybe_quantized_matmul`, every norm
through the row-invariant norm kernel.  Attention is plain PyTorch, as the
reference's is plain jnp.

Cache writes happen in place: where the reference returns an updated copy
of the cache (``dynamic_update_slice``), the port writes into the cache
tensors it is given and returns them.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.rowinv import rowinv_norm
from repro_torch.quant.qmatmul import maybe_quantized_matmul

Params = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# Norms.
# ---------------------------------------------------------------------------


def norm_init(d: int, device, kind: str = "rms") -> Params:
    p = {"scale": torch.ones((d,), dtype=torch.float32, device=device)}
    if kind == "ln":
        p["bias"] = torch.zeros((d,), dtype=torch.float32, device=device)
    return p


def norm_apply(p: Params, x: torch.Tensor, kind: str = "rms",
               eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm (``kind="rms"``) or LayerNorm with bias (``"ln"``) over the
    last axis in fp32, cast back to the input dtype: on the card the
    row-invariant kernel (:func:`repro_torch.kernels.rowinv.rowinv_norm`),
    so a row's bits never depend on how many rows a call has."""
    return rowinv_norm(x, p["scale"], p.get("bias"), kind=kind, eps=eps)


# ---------------------------------------------------------------------------
# Rotary position embeddings.
# ---------------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (B, S, H, D) with D even; positions: (S,) or (B, S)."""
    d = x.shape[-1]
    exps = -torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d
    freqs = torch.pow(torch.full_like(exps, theta), exps)
    if positions.dim() == 1:
        ang = positions.to(torch.float32)[:, None] * freqs[None, :]
        ang = ang[None, :, None, :]
    else:
        ang = positions.to(torch.float32)[..., None] * freqs
        ang = ang[:, :, None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Activations / MLP.
# ---------------------------------------------------------------------------


def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")
    if kind == "relu2":
        r = F.relu(x)
        return r * r
    raise ValueError(f"unknown activation {kind!r}")


def _normal(gen: torch.Generator, shape, scale: float, dtype,
            device) -> torch.Tensor:
    out = torch.randn(shape, generator=gen, dtype=torch.float32,
                      device=device)
    return (out * scale).to(dtype)


def mlp_init(gen: torch.Generator, d: int, ff: int, glu: bool, dtype,
             device) -> Params:
    s_in, s_out = d ** -0.5, ff ** -0.5
    p = {"wi": _normal(gen, (d, ff), s_in, dtype, device),
         "wo": _normal(gen, (ff, d), s_out, dtype, device)}
    if glu:
        p["wg"] = _normal(gen, (d, ff), s_in, dtype, device)
    return p


def mlp_apply(p: Params, x: torch.Tensor, act: str, glu: bool, quant,
              name: str) -> torch.Tensor:
    up = maybe_quantized_matmul(x, p["wi"], quant, f"{name}.wi")
    if glu:
        gate = maybe_quantized_matmul(x, p["wg"], quant, f"{name}.wg")
        h = _act(gate, act) * up
    else:
        h = _act(up, act)
    return maybe_quantized_matmul(h, p["wo"], quant, f"{name}.wo")


# ---------------------------------------------------------------------------
# Attention (GQA/MQA).
# ---------------------------------------------------------------------------


def attn_init(gen: torch.Generator, cfg, dtype, device) -> Params:
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    s = d ** -0.5
    return {
        "wq": _normal(gen, (d, qd), s, dtype, device),
        "wk": _normal(gen, (d, kvd), s, dtype, device),
        "wv": _normal(gen, (d, kvd), s, dtype, device),
        "wo": _normal(gen, (qd, d), qd ** -0.5, dtype, device),
    }


def _qkv(p: Params, x: torch.Tensor, cfg, quant, name: str):
    b, s, _ = x.shape
    q = maybe_quantized_matmul(x, p["wq"], quant, f"{name}.wq")
    k = maybe_quantized_matmul(x, p["wk"], quant, f"{name}.wk")
    v = maybe_quantized_matmul(x, p["wv"], quant, f"{name}.wv")
    q = q.reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = k.reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    return q, k, v


def _attend(qc: torch.Tensor, kt: torch.Tensor, vt: torch.Tensor,
            mask: torch.Tensor, scale: float) -> torch.Tensor:
    """qc (B, c, K, G, D) against kt/vt (B, T, K, D) under mask
    (B or 1, c, T): scores in fp32, probabilities in the query's dtype."""
    scores = torch.einsum("bckgd,bskd->bckgs", qc, kt).to(torch.float32)
    scores = scores * scale
    scores = torch.where(mask[:, :, None, None, :], scores,
                         torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1).to(qc.dtype)
    return torch.einsum("bckgs,bskd->bckgd", probs, vt)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, chunk: int = 256) -> torch.Tensor:
    """Query-chunked attention over a whole sequence.  q: (B, S, H, D);
    k, v: (B, T, K, D) with H = K * G.  O(chunk * T) score memory."""
    b, s, h, d = q.shape
    kh = k.shape[2]
    g = h // kh
    chunk = min(chunk, s)
    while s % chunk:
        chunk //= 2
    qr = q.reshape(b, s // chunk, chunk, kh, g, d)
    kt, vt = k.to(q.dtype), v.to(q.dtype)
    positions = torch.arange(k.shape[1], dtype=torch.int32, device=q.device)
    outs = []
    for ci in range(s // chunk):
        if causal:
            row = ci * chunk + torch.arange(chunk, dtype=torch.int32,
                                            device=q.device)
            mask = (positions[None, :] <= row[:, None])[None]
        else:
            mask = torch.ones((1, chunk, k.shape[1]), dtype=torch.bool,
                              device=q.device)
        outs.append(_attend(qr[:, ci], kt, vt, mask, d ** -0.5))
    return torch.stack(outs, dim=1).reshape(b, s, h, d)


def cached_attention(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                     q_offset: int, *,
                     kv_valid: Optional[torch.Tensor] = None,
                     chunk: int = 256) -> torch.Tensor:
    """Attention of a query chunk at positions q_offset.. against the KV
    cache (B, Smax, K, D); ``kv_valid`` (B, Smax) masks pad slots."""
    b, c, h, d = q.shape
    kh = ck.shape[2]
    g = h // kh
    sub = min(chunk, c)
    while c % sub:
        sub //= 2
    qr = q.reshape(b, c // sub, sub, kh, g, d)
    kt, vt = ck.to(q.dtype), cv.to(q.dtype)
    kvpos = torch.arange(ck.shape[1], dtype=torch.int32, device=q.device)
    outs = []
    for ci in range(c // sub):
        row = q_offset + ci * sub + torch.arange(sub, dtype=torch.int32,
                                                 device=q.device)
        mask = (kvpos[None, :] <= row[:, None])[None]
        if kv_valid is not None:
            mask = mask & kv_valid[:, None, :]
        outs.append(_attend(qr[:, ci], kt, vt, mask, d ** -0.5))
    return torch.stack(outs, dim=1).reshape(b, c, h, d)


def attn_prefill_chunk(p: Params, x: torch.Tensor, cache: Params,
                       offset: int, cfg, quant, name: str,
                       positions: Optional[torch.Tensor] = None,
                       kv_valid: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, Params]:
    """One prefill chunk: project, write K/V into the cache at ``offset``
    (in place), attend against everything cached so far."""
    b, c, _ = x.shape
    q, k, v = _qkv(p, x, cfg, quant, name)
    pos = positions if positions is not None else offset + torch.arange(
        c, dtype=torch.int32, device=x.device)
    q = rope(q, pos, cfg.rope_theta)
    k = rope(k, pos, cfg.rope_theta)
    ck, cv = cache["k"], cache["v"]
    # dynamic_update_slice clamps the start so the update fits
    start = min(max(int(offset), 0), ck.shape[1] - c)
    ck[:, start:start + c] = k.to(ck.dtype)
    cv[:, start:start + c] = v.to(cv.dtype)
    out = cached_attention(q, ck, cv, offset, kv_valid=kv_valid)
    out = out.reshape(b, c, cfg.q_dim)
    out = maybe_quantized_matmul(out, p["wo"], quant, f"{name}.wo")
    return out, {"k": ck, "v": cv}


def _as_batch_vec(pos, b: int, device) -> torch.Tensor:
    pos = torch.as_tensor(pos, dtype=torch.int32, device=device)
    return pos.expand(b) if pos.dim() == 0 else pos


def attn_decode(p: Params, x: torch.Tensor, cache: Params, pos, cfg, quant,
                name: str, positions=None,
                kv_valid: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Params]:
    """One-token decode: x (B, 1, d); cache k/v (B, Smax, K, D), written in
    place at ``pos`` — a scalar or a (B,) vector (each slot at its own
    depth).  ``positions`` optionally gives distinct RoPE positions."""
    b = x.shape[0]
    q, k, v = _qkv(p, x, cfg, quant, name)
    pos_b = _as_batch_vec(pos, b, x.device)
    rpos = pos_b if positions is None else _as_batch_vec(positions, b,
                                                         x.device)
    q = rope(q, rpos[:, None], cfg.rope_theta)
    k = rope(k, rpos[:, None], cfg.rope_theta)
    ck, cv = cache["k"], cache["v"]
    rows = torch.arange(b, device=x.device)
    at = pos_b.clamp(0, ck.shape[1] - 1).long()
    ck[rows, at] = k[:, 0].to(ck.dtype)
    cv[rows, at] = v[:, 0].to(cv.dtype)
    kh, d = cfg.n_kv_heads, cfg.head_dim
    g = cfg.n_heads // kh
    qv = q.reshape(b, kh, g, d)
    scores = torch.einsum("bkgd,bskd->bkgs", qv,
                          ck.to(q.dtype)).to(torch.float32)
    scores = scores * (d ** -0.5)
    valid = (torch.arange(ck.shape[1], dtype=torch.int32,
                          device=x.device)[None, :] <= pos_b[:, None])
    if kv_valid is not None:
        valid = valid & kv_valid
    scores = torch.where(valid[:, None, None, :], scores,
                         torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgs,bskd->bkgd", probs, cv.to(q.dtype))
    out = out.reshape(b, 1, cfg.q_dim)
    out = maybe_quantized_matmul(out, p["wo"], quant, f"{name}.wo")
    return out, {"k": ck, "v": cv}
