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
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Tuple

import torch

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


def init(params: Params) -> OptState:
    zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    device = tree_leaves(params)[0].device
    return OptState(step=torch.zeros((), dtype=torch.int32, device=device),
                    mu=zeros, nu=tree_map(torch.clone, zeros))


def global_norm(tree: Params) -> torch.Tensor:
    total = None
    for x in tree_leaves(tree):
        sq = torch.sum(torch.square(x.to(torch.float32)))
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
        g = g.to(torch.float32) * clip
        mu = b1 * mu + (1 - b1) * g
        nu = b2 * nu + (1 - b2) * g * g
        upd = (mu / c1) / (torch.sqrt(nu / c2) + cfg.eps)
        if p.dim() >= 2:    # decay matrices only (standard practice)
            upd = upd + cfg.weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr * upd).to(p.dtype), mu, nu

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
