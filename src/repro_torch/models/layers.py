"""Model building blocks (port of ``repro.models.layers``): RMSNorm and
LayerNorm, RoPE, the MLP (gated or plain), GQA attention for training
(chunked causal over the whole sequence), prefill (chunked, against the KV
cache) and one-token decode, and the encoder-decoder's cross-attention
over a precomputed memory.

Plain functions on tensors and parameter dicts, in the reference's layouts:
activations (B, S, d), heads (B, S, H, D), caches (B, Smax, K, D).  Every
weight matmul goes through :func:`maybe_quantized_matmul`, every norm
through the row-invariant norm kernel.  Attention is plain PyTorch, as the
reference's is plain jnp.

Where the K/V cache a layer is given holds fewer kv heads than the model
has (the pool's block under a mesh whose ``model`` axis divides them,
:func:`repro_torch.dist.sharding.page_pool_sharding`), prefill and decode
attention run head-parallel, the port's counterpart of the reference's
GSPMD partitioning of attention: each model rank slices its kv-head
groups (and their query heads) from the replicated q/k/v with no
communication, attends against its block of the K/V pool, and the heads
are all-gathered over the ambient mesh's ``model`` axis before ``wo``.
Training's attention runs head-parallel the same way under a mesh whose
``model`` axis divides the kv heads; the gather's backward takes each
rank's heads back, and the slices' backward sums the heads' gradients
over ``model``.  The recurrent blocks (``models.rwkv``, ``models.ssm``)
cut their heads and channels with the same helpers (:func:`train_block`,
:func:`block_start`, :func:`replicated`, :func:`_all_heads`).

Cache writes happen in place: where the reference returns an updated copy
of the cache (``dynamic_update_slice``), the port writes into the cache
tensors it is given and returns them.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.dist import collectives as dist_coll
from repro_torch.dist import sharding as dist_sharding
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


def _local_heads(qkv, cfg, kh: int):
    """This model rank's ``kh`` kv heads (and their query heads) of the
    (B, S, H, D) projections ``qkv`` where the cache holds ``kh`` of the
    model's kv heads (the pool's ``model`` block), else all of them; with
    whether the heads were cut."""
    q, k, v = qkv
    if kh == cfg.n_kv_heads:
        return q, k, v, False
    h0 = block_start(kh)
    g = cfg.n_heads // cfg.n_kv_heads
    # each model rank uses its heads of the replicated projections: in the
    # backward their gradients are put back together over ``model``
    q, k, v = (replicated(t) for t in (q, k, v))
    return (q[:, :, h0 * g:(h0 + kh) * g], k[:, :, h0:h0 + kh],
            v[:, :, h0:h0 + kh], True)


def _all_heads(out: torch.Tensor, cut: bool) -> torch.Tensor:
    """(B, S, local heads * D) -> every head, all-gathered over ``model``
    in head order, where :func:`_local_heads` cut them (and the recurrent
    blocks' heads or channels likewise)."""
    if not cut:
        return out
    # the backward takes this rank's heads back (``wo``'s dx is the same
    # on every model rank): no sum
    return dist_coll.all_gather_grad_take(out, dist_sharding.current_mesh(),
                                          ("model",), out.dim() - 1)


def train_block(n: int) -> int:
    """How many of ``n`` heads (or channels) one model rank runs in
    training: its block of them where the ambient mesh's ``model`` axis
    divides ``n`` (as it divides the pool's in serving), else all of
    them."""
    mesh = dist_sharding.current_mesh()
    if mesh is None:
        return n
    size = dist_sharding.mesh_axis_size(mesh, "model")
    if size > 1 and n % size == 0:
        return n // size
    return n


def block_start(n_local: int) -> int:
    """Where this model rank's block of ``n_local`` heads (or channels)
    starts: its ``model`` coordinate on the ambient mesh times the block."""
    mesh = dist_sharding.current_mesh()
    return dist_sharding.coordinate(mesh)["model"] * n_local


def replicated(x: torch.Tensor) -> torch.Tensor:
    """``x``, which every model rank holds whole and cuts its own block
    from, with its gradient summed over the ambient mesh's ``model`` axis
    (each rank's backward forms only its block's part)."""
    return dist_coll.replicate_grad_sum(x, dist_sharding.current_mesh(),
                                        ("model",))


def _scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q (B, K, M, D) against k (B, K, T, D): the (B, K, M, T) products, as
    ``k @ q^T``.  With one query row a kv head (M = 1: the decode of a
    model whose every head is a kv head), ``q @ k^T`` — and the einsum it
    lowers to — sums each score in an order that on the CPU depends on B
    and K, which a mesh cuts; ``k @ q^T`` sums it the same way whatever
    their counts, so a data or model rank's rows are the unsharded
    ones."""
    return torch.matmul(k, q.transpose(-1, -2)).transpose(-1, -2)


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


def chunked_causal_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *,
                             chunk: int = 256) -> torch.Tensor:
    """The reference's alias: :func:`chunked_attention`, causal."""
    return chunked_attention(q, k, v, causal=True, chunk=chunk)


def attn_train(p: Params, x: torch.Tensor, cfg, quant, name: str,
               positions: Optional[torch.Tensor] = None,
               chunk: int = 256) -> torch.Tensor:
    """Causal self-attention over a whole training sequence x (B, S, d):
    projections, RoPE at ``positions`` (default 0..S-1), chunked causal
    attention, output projection.  The reference recomputes each query
    chunk's scores in the backward (``jax.checkpoint``); here the period's
    remat (``models.lm._scan_blocks``) already bounds them to one layer.
    Under a mesh whose ``model`` axis divides the kv heads it runs
    head-parallel, as serving does: each model rank attends with its heads
    (:func:`train_block` of the kv heads), gathered before ``wo``."""
    b, s, _ = x.shape
    q, k, v, cut = _local_heads(_qkv(p, x, cfg, quant, name), cfg,
                                train_block(cfg.n_kv_heads))
    pos = positions if positions is not None else torch.arange(
        s, dtype=torch.int32, device=x.device)
    q = rope(q, pos, cfg.rope_theta)
    k = rope(k, pos, cfg.rope_theta)
    out = chunked_causal_attention(q, k, v, chunk=chunk)
    out = _all_heads(out.reshape(b, s, -1), cut)
    return maybe_quantized_matmul(out, p["wo"], quant, f"{name}.wo")


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
    ck, cv = cache["k"], cache["v"]
    q, k, v, cut = _local_heads(_qkv(p, x, cfg, quant, name), cfg,
                                ck.shape[2])
    pos = positions if positions is not None else offset + torch.arange(
        c, dtype=torch.int32, device=x.device)
    q = rope(q, pos, cfg.rope_theta)
    k = rope(k, pos, cfg.rope_theta)
    # dynamic_update_slice clamps the start so the update fits
    start = min(max(int(offset), 0), ck.shape[1] - c)
    ck[:, start:start + c] = k.to(ck.dtype)
    cv[:, start:start + c] = v.to(cv.dtype)
    out = cached_attention(q, ck, cv, offset, kv_valid=kv_valid)
    out = _all_heads(out.reshape(b, c, -1), cut)
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
    ck, cv = cache["k"], cache["v"]
    q, k, v, cut = _local_heads(_qkv(p, x, cfg, quant, name), cfg,
                                ck.shape[2])
    pos_b = _as_batch_vec(pos, b, x.device)
    rpos = pos_b if positions is None else _as_batch_vec(positions, b,
                                                         x.device)
    q = rope(q, rpos[:, None], cfg.rope_theta)
    k = rope(k, rpos[:, None], cfg.rope_theta)
    rows = torch.arange(b, device=x.device)
    at = pos_b.clamp(0, ck.shape[1] - 1).long()
    ck[rows, at] = k[:, 0].to(ck.dtype)
    cv[rows, at] = v[:, 0].to(cv.dtype)
    kh, d = ck.shape[2], cfg.head_dim
    g = cfg.n_heads // cfg.n_kv_heads
    qv = q.reshape(b, kh, g, d)
    scores = _scores(qv, ck.to(q.dtype).transpose(1, 2)).to(torch.float32)
    scores = scores * (d ** -0.5)
    valid = (torch.arange(ck.shape[1], dtype=torch.int32,
                          device=x.device)[None, :] <= pos_b[:, None])
    if kv_valid is not None:
        valid = valid & kv_valid
    scores = torch.where(valid[:, None, None, :], scores,
                         torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgs,bskd->bkgd", probs, cv.to(q.dtype))
    out = _all_heads(out.reshape(b, 1, -1), cut)
    out = maybe_quantized_matmul(out, p["wo"], quant, f"{name}.wo")
    return out, {"k": ck, "v": cv}


# ---------------------------------------------------------------------------
# Cross-attention (encoder-decoder).
# ---------------------------------------------------------------------------


def xattn_apply(p: Params, x: torch.Tensor, mem_k: torch.Tensor,
                mem_v: torch.Tensor, cfg, quant, name: str) -> torch.Tensor:
    """x: (B, S, d) queries; mem_k/mem_v: (B, T, K, D) projected from the
    encoder output once a request (:func:`xattn_mem`).  Every frame is
    attended (no mask); scores in fp32, probabilities in the query's
    dtype."""
    b, s, _ = x.shape
    q = maybe_quantized_matmul(x, p["wq"], quant, f"{name}.wq")
    kh, d = cfg.n_kv_heads, cfg.head_dim
    g = cfg.n_heads // kh
    qv = q.reshape(b, s, kh, g, d).transpose(1, 2).reshape(b, kh, s * g, d)
    scores = _scores(qv, mem_k.to(q.dtype).transpose(1, 2))
    scores = scores.reshape(b, kh, s, g, -1).transpose(1, 2)
    scores = scores.to(torch.float32) * (d ** -0.5)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bskgt,btkd->bskgd", probs, mem_v.to(q.dtype))
    out = out.reshape(b, s, cfg.q_dim)
    return maybe_quantized_matmul(out, p["wo"], quant, f"{name}.wo")


def xattn_mem(p: Params, enc_out: torch.Tensor, cfg, quant, name: str
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The encoder output (B, T, d) projected to cross-attention K/V, each
    (B, T, K, D)."""
    b, t, _ = enc_out.shape
    k = maybe_quantized_matmul(enc_out, p["wk"], quant, f"{name}.wk")
    v = maybe_quantized_matmul(enc_out, p["wv"], quant, f"{name}.wv")
    return (k.reshape(b, t, cfg.n_kv_heads, cfg.head_dim),
            v.reshape(b, t, cfg.n_kv_heads, cfg.head_dim))
