"""AdamW and its learning-rate schedule, from scratch on tensor dicts (port
of ``repro.train.optim``).

State is fp32 whatever the parameter dtype.  The arithmetic is the
reference's, in its order: the global-norm clip, then per leaf
``mu = b1 mu + (1 - b1) g``, ``nu = b2 nu + (1 - b2) g^2``, the bias
corrections ``(mu / c1) / (sqrt(nu / c2) + eps)``, weight decay on
matrices only (``ndim >= 2``) and ``p - lr * upd``.  ``torch.optim.AdamW``
orders these differently (decay before the moment update, eps added to a
bias-corrected denominator), so it is not used.  Step-dependent scalars
(lr, the bias corrections) are 0-d fp32 tensors on the parameters'
device, and every division is tensor by tensor: on CUDA, division by a
Python scalar multiplies by its reciprocal, which the reference does not.

Trees are nested dicts of tensors; the global norm sums the leaves in
sorted-key order, the order in which JAX flattens a dict.

Under a mesh a leaf may be a DTensor holding this rank's block
(``lm.init_params(mesh=...)``): its state is held as it is, and the
update runs on the local blocks alone, the reference's "mu and nu follow
their parameter's block".  The global norm is the logical gradient's: a
leaf's squares are summed over the mesh axes its blocks differ over, so
a block replicated over an axis counts once; the clip, lr and step then
agree on every rank.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.dist import collectives as C
from repro_torch.dist import sharding as S

Params = Any


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


class OptState(NamedTuple):
    step: torch.Tensor          # 0-d int32
    mu: Params
    nu: Params


def tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts of one structure."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def tree_leaves(tree) -> list:
    """The leaves in sorted-key order (JAX's dict flattening order)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def _f32(value, device) -> torch.Tensor:
    return torch.full((), value, dtype=torch.float32, device=device)


def lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to ``min_lr_ratio`` (0-d fp32)."""
    dev = step.device
    step = step.to(torch.float32)
    warm = torch.clamp_max(step / _f32(max(cfg.warmup_steps, 1), dev), 1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / _f32(max(cfg.total_steps - cfg.warmup_steps, 1),
                              dev), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(_f32(math.pi, dev) * prog))
    frac = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
    return _f32(cfg.lr, dev) * warm * frac


def _zeros_like(p) -> torch.Tensor:
    block = S.local(p)
    return S.like(p, torch.zeros(block.shape, dtype=torch.float32,
                                 device=block.device))


def init(params: Params) -> OptState:
    device = S.local(tree_leaves(params)[0]).device
    return OptState(step=torch.zeros((), dtype=torch.int32, device=device),
                    mu=tree_map(_zeros_like, params),
                    nu=tree_map(_zeros_like, params))


def global_norm(tree: Params) -> torch.Tensor:
    """The L2 norm over every leaf.  Each leaf's local squares add to the
    partial sum of the mesh axes its blocks differ over (none for a plain
    tensor); each partial is all-reduced over its axes once, in first-seen
    order, so a tree of plain tensors sums exactly as unsharded."""
    partial: Dict[Tuple[str, ...], list] = {}
    for x in tree_leaves(tree):
        sq = torch.sum(torch.square(S.local(x).to(torch.float32)))
        axes = S.sharded_axes(x)
        if axes in partial:
            partial[axes][1] = partial[axes][1] + sq
        else:
            partial[axes] = [x.device_mesh if axes else None, sq]
    total = None
    for axes, (mesh, sq) in partial.items():
        if axes:
            sq = C.all_reduce(sq, mesh, axes)
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def update(cfg: AdamWConfig, grads: Params, state: OptState, params: Params
           ) -> Tuple[Params, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step; returns (new_params, new_state, metrics)."""
    gnorm = global_norm(grads)
    dev = gnorm.device
    clip = torch.clamp_max(_f32(cfg.grad_clip, dev)
                           / torch.clamp_min(gnorm, 1e-12), 1.0)
    step = state.step + 1
    lr = lr_at(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    stepf = step.to(torch.float32)
    c1 = 1.0 - torch.pow(_f32(b1, dev), stepf)
    c2 = 1.0 - torch.pow(_f32(b2, dev), stepf)

    new_p, new_mu, new_nu = {}, {}, {}

    def leaf(p, g, mu, nu):
        pl, ml, nl = S.local(p), S.local(mu), S.local(nu)
        g = S.local(g).to(torch.float32) * clip
        ml = b1 * ml + (1 - b1) * g
        nl = b2 * nl + (1 - b2) * g * g
        upd = (ml / c1) / (torch.sqrt(nl / c2) + cfg.eps)
        if p.dim() >= 2:    # decay matrices only (standard practice)
            upd = upd + cfg.weight_decay * pl.to(torch.float32)
        new = (pl.to(torch.float32) - lr * upd).to(pl.dtype)
        return S.like(p, new), S.like(mu, ml), S.like(nu, nl)

    flat = tree_map(leaf, params, grads, state.mu, state.nu)
    is_triple = lambda t: isinstance(t, tuple)   # noqa: E731
    new_p = _pick(flat, 0, is_triple)
    new_mu = _pick(flat, 1, is_triple)
    new_nu = _pick(flat, 2, is_triple)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return new_p, OptState(step, new_mu, new_nu), metrics


def _pick(tree, i: int, is_leaf):
    if is_leaf(tree):
        return tree[i]
    return {k: _pick(v, i, is_leaf) for k, v in tree.items()}
