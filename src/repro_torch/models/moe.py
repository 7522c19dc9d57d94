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

The Switch load-balance loss is training's: ``moe_apply(...,
with_aux=True)`` returns it beside the output, as the reference's
``moe_apply`` does, through :func:`load_balance_loss`; serving drops it.

Dispatch metrics.  The reference observes every dispatch's live tokens per
expert and its capacity drops through ``jax.debug.callback``, which runs on
every call of the compiled step.  Here a host read in the step would add a
sync and break a decode graph's capture, so with metrics enabled each layer
keeps persistent device accumulators (:class:`_DispatchAccum`: the
histogram's bucket counts, sum and count, and the drops) that the step
updates in place with capturable ops; a graph captured so replays them.
The updates are integer and outside autograd; a training step's backward
that recomputes a period (remat) routes again, and that recomputed
dispatch is not observed: each dispatch counts once, in the forward.
The registry folds them into ``repro_moe_tokens_per_expert`` and
``repro_moe_dropped_tokens_total`` only when it is read
(``obs.metrics.snapshot`` / ``prometheus_text`` / ``collect``).  With
metrics disabled the step allocates and launches nothing extra, and a
graph captured then never counts.  Under a mesh each rank's registry counts
its own data rank's rows (the model ranks of one data rank route the same
rows, so they count the same); the engine's parking-row prefill, which
serves no request, is kept out of them as a capture's warm-up step is
(:func:`save_dispatch_metrics`).

Under a mesh (the ambient one) each data rank routes its own rows, the
router's GEMM runs N-sharded, and the three expert GEMMs run
expert-parallel: each ``model`` rank launches the grouped kernel over its
E / model experts (``quant.qmatmul``), the capacity still per sequence.
Training's aux loss takes its means over the global microbatch
(:func:`load_balance_loss`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from repro_torch.dist import collectives as C
from repro_torch.dist.sharding import current_mesh, data_axes, data_size
from repro_torch.models.layers import _act, _normal
from repro_torch.obs import metrics as obs_metrics
from repro_torch.quant.qmatmul import (maybe_quantized_batched,
                                       maybe_quantized_matmul)

Params = Dict[str, torch.Tensor]

_DISPATCH_BUCKETS = (0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0,
                     512.0, 1024.0)
_TOKENS_PER_EXPERT = obs_metrics.histogram(
    "repro_moe_tokens_per_expert",
    "live (post-capacity) tokens per expert per dispatch, by layer; "
    "accumulated on the device and folded in when the registry is read, so "
    "a decode graph's replays count (one observation per lane and expert "
    "each replay) if the graph was captured with metrics enabled",
    labels=("layer",), buckets=_DISPATCH_BUCKETS)
_DROPPED_TOKENS = obs_metrics.counter(
    "repro_moe_dropped_tokens_total",
    "token->expert assignments dropped by the capacity bound, by layer; "
    "accumulated on the device like repro_moe_tokens_per_expert",
    labels=("layer",))


class _DispatchAccum:
    """One layer's dispatch observations on one device: ``state`` holds the
    histogram's per-bucket counts (the ``+Inf`` overflow last), the sum of
    the observed counts, their number and the drops, all int64 (the
    observations are integers, so the sums are exact)."""

    def __init__(self, device: torch.device):
        nb = len(_DISPATCH_BUCKETS) + 1
        with torch.inference_mode(False):      # updated in and out of it
            self.bounds = torch.tensor(_DISPATCH_BUCKETS, device=device
                                       ).to(torch.int64)
            self.slots = torch.arange(nb, device=device)
            self.state = torch.zeros(nb + 3, dtype=torch.int64,
                                     device=device)

    def update(self, live: torch.Tensor, assignments: int) -> None:
        """Add one dispatch: ``live`` (B, E) tokens per sequence and expert
        (one observation each), ``assignments`` = B * S * top_k."""
        flat = live.reshape(-1).to(torch.int64)
        idx = torch.bucketize(flat, self.bounds)   # first bound >= count
        kept = flat.sum()
        self.state += torch.cat([
            (idx[:, None] == self.slots).sum(0),
            torch.stack([kept, torch.full_like(kept, flat.numel()),
                         assignments - kept])])


_ACCUMS: Dict[Tuple[str, torch.device], _DispatchAccum] = {}


def _observe_dispatch(name: str, live: torch.Tensor, assignments: int
                      ) -> None:
    key = (name, live.device)
    acc = _ACCUMS.get(key)
    if acc is None:         # setdefault: one accumulator if threads race
        acc = _ACCUMS.setdefault(key, _DispatchAccum(live.device))
    acc.update(live, assignments)


def save_dispatch_metrics() -> Dict[Tuple[str, torch.device], torch.Tensor]:
    """A copy of every layer's accumulators (on their devices), for
    :func:`restore_dispatch_metrics`: the decode graph's eager warm-up step
    and the engine's parking-row prefill under a mesh are not dispatches
    the reference would observe."""
    return {k: a.state.clone() for k, a in _ACCUMS.items()}


def restore_dispatch_metrics(saved) -> None:
    """Put the accumulators back as :func:`save_dispatch_metrics` found
    them; one created since starts again from zero."""
    for k, a in _ACCUMS.items():
        if k in saved:
            a.state.copy_(saved[k])
        else:
            a.state.zero_()


def _collect_dispatch() -> None:
    """Fold every layer's accumulators into the host instruments and zero
    them (a collector of :mod:`repro_torch.obs.metrics`)."""
    nb = len(_DISPATCH_BUCKETS) + 1
    for (name, _), acc in list(_ACCUMS.items()):
        vals = acc.state.tolist()
        if vals[nb + 1]:
            _TOKENS_PER_EXPERT._merge((name,), vals[:nb], float(vals[nb]),
                                      vals[nb + 1])
            _DROPPED_TOKENS._add((name,), float(vals[nb + 2]))
        acc.state.zero_()


obs_metrics.add_collector(_collect_dispatch)


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
    if obs_metrics.enabled() and not _in_backward():
        _observe_dispatch(name, live, b * s * k)
    return Routing(
        probs=probs,
        expert_ids=torch.gather(expert_ids, -1, asc),
        gates=torch.gather(gate_vals, -1, asc),
        slot=torch.gather(slot, -1, asc),
        keep=torch.gather(keep, -1, asc),
        counts=live.T.to(torch.int32).contiguous(),
        cap=cap)


def _in_backward() -> bool:
    """True while autograd runs a backward (a remat recompute)."""
    return torch._C._current_graph_task_id() != -1


def moe_apply(p: Params, x: torch.Tensor, cfg, quant, name: str, *,
              with_aux: bool = False):
    """x: (B, S, d) -> (B, S, d); with ``with_aux`` (training) the pair
    (out, the Switch load-balance loss)."""
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
    if with_aux:
        return out, load_balance_loss(r, e)
    return out


def load_balance_loss(r: Routing, n_experts: int) -> torch.Tensor:
    """Switch-style load-balance loss (batch mean), for training: E times
    the dot of the mean router probability and the mean top-k assignment
    share per expert.

    Under a mesh with data ranks (the ambient one: ``r`` routed this data
    rank's rows) both means are the global microbatch's, as the
    reference's GSPMD means are: each per-expert sum and the row count
    summed over the data axes before the division and the product — the
    probabilities' sum with its gradient passed to each rank's own rows
    (``all_reduce_grad_pass``), the assignments' (no gradient) plainly.
    Per-rank aux values are never averaged: E * sum(me * ce) is not linear
    in the rows."""
    onehot = torch.nn.functional.one_hot(r.expert_ids, n_experts)
    mesh = current_mesh()
    if mesh is None or data_size(mesh) == 1:
        me = r.probs.mean(dim=(0, 1))                              # (E,)
        ce = onehot.to(torch.float32).mean(dim=(0, 1, 2))
        return n_experts * torch.sum(me * ce)
    daxes = data_axes(mesh)
    b, s, k = r.expert_ids.shape
    psum = C.all_reduce_grad_pass(r.probs.sum(dim=(0, 1)), mesh, daxes)
    csum = C.all_reduce(onehot.to(torch.float32).sum(dim=(0, 1, 2)), mesh,
                        daxes)
    rows = C.all_reduce(torch.full((), b * s, dtype=torch.float32,
                                   device=psum.device), mesh, daxes)
    me = psum / rows
    ce = csum / (rows * k)
    return n_experts * torch.sum(me * ce)
