"""Mixture-of-Experts MLP with per-sequence sort-based capacity dispatch
(port of ``repro.models.moe``).

Every sequence routes its own tokens: top-k experts per token from a
softmax over the router logits, a stable sort of the (token, choice) pairs
by expert, and each expert's first ``cap`` tokens in that order kept
(capacity ``cap`` = S * top_k * factor / E, floor 8, rounded up to 8).
Overflow drops ride the residual.  The dispatch is batched over B with
tensor ops: no Python loop over the batch or the experts, and no host sync
(``counts`` stays on the device, where the grouped kernel reads it).

The three expert GEMMs run as ragged grouped launches with
``counts = live.T`` (E, B) and ``seg = cap``: batch b occupies segment b of
each expert's (B * cap) rows, and rows past ``counts[e, b]`` are zero
padding that the kernel writes as exact zeros.

Numerics that follow the reference:

  * top-k ties go to the lower expert index (``jax.lax.top_k``): a stable
    descending sort;
  * the dispatch sort is stable (``jnp.argsort``), so ranks, slots and
    overflow drops match;
  * the combine adds each token's k contributions in ascending expert
    order, one rounded add at a time from zero — the order in which the
    reference's scatter-add applies its sorted updates.  A gather and a
    fixed-order sum replace the scatter-add, so the result is the same on
    every run (``index_add_`` on CUDA adds with atomics in no fixed order).

The Switch load-balance loss is training-only and not on the serve path:
:func:`load_balance_loss` computes it from :func:`route`'s outputs.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch

from repro_torch.models.layers import _act, _normal
from repro_torch.quant.qmatmul import (maybe_quantized_batched,
                                       maybe_quantized_matmul)

Params = Dict[str, torch.Tensor]


def moe_init(gen: torch.Generator, cfg, dtype, device) -> Params:
    d = cfg.d_model
    fe = cfg.d_ff_expert or cfg.d_ff
    e = cfg.n_experts
    s_in, s_out = d ** -0.5, fe ** -0.5
    p = {
        "router": _normal(gen, (d, e), s_in, torch.float32, device),
        "wi": _normal(gen, (e, d, fe), s_in, dtype, device),
        "wo": _normal(gen, (e, fe, d), s_out, dtype, device),
    }
    if cfg.glu:
        p["wg"] = _normal(gen, (e, d, fe), s_in, dtype, device)
    return p


def _capacity(tokens: int, top_k: int, n_experts: int, factor: float) -> int:
    cap = int(tokens * top_k * factor / n_experts)
    return max(8, -(-cap // 8) * 8)


@dataclass
class Routing:
    """One MoE layer's dispatch, batched over B.

    Per (token, choice), choices in ascending expert order: ``expert_ids``,
    ``gates`` (renormalized top-k probabilities, fp32), ``slot`` (row of
    the (E * cap) expert buffer, ``E * cap`` when dropped) and ``keep``
    (B, S, k).  ``counts`` (E, B) int32: live rows per expert and sequence.
    """

    probs: torch.Tensor          # (B, S, E) fp32 router softmax
    expert_ids: torch.Tensor     # (B, S, k) int64
    gates: torch.Tensor          # (B, S, k) fp32
    slot: torch.Tensor           # (B, S, k) int64
    keep: torch.Tensor           # (B, S, k) bool
    counts: torch.Tensor         # (E, B) int32
    cap: int


def route(p: Params, x: torch.Tensor, cfg, quant, name: str) -> Routing:
    """Router GEMM, softmax, top-k and the sort-based capacity dispatch
    (the reference's ``dispatch_one``, batched over B)."""
    b, s, _ = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = _capacity(s, k, e, cfg.capacity_factor)
    logits = maybe_quantized_matmul(x.to(torch.float32), p["router"], quant,
                                    f"{name}.router")
    probs = torch.softmax(logits.to(torch.float32), dim=-1)      # (B, S, E)

    # top-k with ties to the lower index, as jax.lax.top_k
    top_vals, top_ids = torch.sort(probs, dim=-1, descending=True,
                                   stable=True)
    gate_vals, expert_ids = top_vals[..., :k], top_ids[..., :k]
    denom = gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    gate_vals = gate_vals / denom

    flat_e = expert_ids.reshape(b, s * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = torch.gather(flat_e, 1, order)                          # sorted ids
    experts = torch.arange(e + 1, device=x.device).expand(b, e + 1)
    bounds = torch.searchsorted(se, experts.contiguous())        # side=left
    group_start = bounds[:, :-1]
    live = (bounds[:, 1:] - group_start).clamp(max=cap)          # (B, E)
    rank = (torch.arange(s * k, device=x.device)
            - torch.gather(group_start, 1, se))
    keep_sorted = rank < cap
    slot_sorted = torch.where(keep_sorted, se * cap + rank,
                              torch.full_like(se, e * cap))
    # back to (token, choice) order: inverse of the sort permutation
    inv = torch.empty_like(order).scatter_(
        1, order, torch.arange(s * k, device=x.device).expand(b, s * k))
    slot = torch.gather(slot_sorted, 1, inv).reshape(b, s, k)
    keep = torch.gather(keep_sorted, 1, inv).reshape(b, s, k)
    # each token's choices in ascending expert order (the combine's order)
    asc = torch.argsort(expert_ids, dim=-1)
    return Routing(
        probs=probs,
        expert_ids=torch.gather(expert_ids, -1, asc),
        gates=torch.gather(gate_vals, -1, asc),
        slot=torch.gather(slot, -1, asc),
        keep=torch.gather(keep, -1, asc),
        counts=live.T.to(torch.int32).contiguous(),
        cap=cap)


def moe_apply(p: Params, x: torch.Tensor, cfg, quant,
              name: str) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    r = route(p, x, cfg, quant, name)
    cap = r.cap

    # Scatter each kept (token, choice) into its expert row; dropped pairs
    # land on a spare last row.  Kept slots are distinct.
    buf = torch.zeros((b, e * cap + 1, d), dtype=x.dtype, device=x.device)
    src = x[:, :, None, :].expand(b, s, k, d).reshape(b, s * k, d)
    buf.scatter_(1, r.slot.reshape(b, s * k, 1).expand(b, s * k, d), src)
    xe = (buf[:, :-1].reshape(b, e, cap, d).transpose(0, 1)
          .reshape(e, b * cap, d))                                 # (E, BC, d)

    up = maybe_quantized_batched(xe, p["wi"], quant, f"{name}.wi",
                                 counts=r.counts, seg=cap)
    if cfg.glu:
        gate = maybe_quantized_batched(xe, p["wg"], quant, f"{name}.wg",
                                       counts=r.counts, seg=cap)
        h = _act(gate, cfg.act) * up
    else:
        h = _act(up, cfg.act)
    out_e = maybe_quantized_batched(h, p["wo"], quant, f"{name}.wo",
                                    counts=r.counts, seg=cap)
    flat = (out_e.reshape(e, b, cap, d).transpose(0, 1)
            .reshape(b, e * cap, d))                               # (B, EC, d)

    # Combine: gather each (token, choice) row, weight it, and sum the k
    # contributions in ascending expert order.
    idx = r.slot.clamp(max=e * cap - 1).reshape(b, s * k, 1)
    gathered = torch.gather(flat, 1, idx.expand(b, s * k, d))
    gathered = gathered.reshape(b, s, k, d)
    contrib = torch.where(r.keep[..., None], gathered,
                          torch.zeros((), dtype=flat.dtype,
                                      device=x.device))
    contrib = contrib * r.gates[..., None].to(flat.dtype)
    out = torch.zeros((b, s, d), dtype=flat.dtype, device=x.device)
    for j in range(k):
        out = out + contrib[:, :, j]
    return out


def load_balance_loss(r: Routing, n_experts: int) -> torch.Tensor:
    """Switch-style load-balance loss (batch mean), for training: E times
    the dot of the mean router probability and the mean top-k assignment
    share per expert."""
    me = r.probs.mean(dim=(0, 1))                                  # (E,)
    onehot = torch.nn.functional.one_hot(r.expert_ids, n_experts)
    ce = onehot.to(torch.float32).mean(dim=(0, 1, 2))
    return n_experts * torch.sum(me * ce)
