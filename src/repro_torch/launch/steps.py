"""The train step (port of ``repro.launch.steps``'s ``make_train_step``).

``make_train_step(cfg, ocfg)`` returns ``train_step(params, opt_state,
batch) -> (params, opt_state, metrics)``: the mean loss and gradient over
``cfg.n_microbatches`` microbatches of the global batch (gradients summed
in fp32 from zero, then divided, as the reference's scan does), then one
AdamW update (``train.optim.update``).  The loss is
``models.lm.loss_fn`` on the ``bf16_cast_params`` compute copy
(:func:`cast_params`); gradients flow back through the casts to the fp32
masters.

The reference's ``abstract_*`` / ``*_specs`` helpers build XLA sharding
specs (``ShapeDtypeStruct`` with ``NamedSharding``) for its dry run; they
have no counterpart here and are not ported.  Its ``make_decode_step`` /
``make_prefill_step`` are the serve executor's (``serve/executor.py``).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.train import optim

Params = Any

# Leaves the bf16 compute copy keeps in fp32 whatever their size (the
# recurrent blocks' decay, bonus and token-shift mixes).
_KEEP_FP32 = ("a_log", "u", "mix")


def cast_params(cfg: ModelConfig, params: Params) -> Params:
    """The bf16 compute copy (``cfg.bf16_cast_params``): every fp32 leaf
    with ``ndim >= 2`` and more than 65536 elements, whose name is not
    ``a_log``, ``u`` or ``mix``, cast to bf16 (differentiably); the rest
    as they are."""
    if not cfg.bf16_cast_params:
        return params

    def walk(tree, name):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if (tree.dtype == torch.float32 and tree.dim() >= 2
                and tree.numel() > 65536 and name not in _KEEP_FP32):
            return tree.to(torch.bfloat16)
        return tree

    return walk(params, "")


def loss_and_grads(cfg: ModelConfig, params: Params,
                   batch: Dict[str, torch.Tensor]):
    """(loss, gradient tree in fp32) of ``loss_fn`` on the compute copy of
    ``params`` (each leaf a fresh autograd leaf); an unused leaf's
    gradient is zeros."""
    leaves = []

    def leaf(p):
        t = p.detach().requires_grad_(True)
        leaves.append(t)
        return t

    req = optim.tree_map(leaf, params)
    with torch.enable_grad():
        loss = lm.loss_fn(cast_params(cfg, req), cfg, batch)
        grads = iter(torch.autograd.grad(loss, leaves, allow_unused=True))
    order = iter(leaves)

    def grad_of(_p):
        g, t = next(grads), next(order)
        return torch.zeros_like(t, dtype=torch.float32) if g is None else g

    return loss.detach(), optim.tree_map(grad_of, params)


def mean_loss_and_grads(cfg: ModelConfig, params: Params,
                        batch: Dict[str, torch.Tensor]):
    """The train step's loss and gradient: over ``cfg.n_microbatches``
    consecutive slices of the global batch's leading axis, summed in fp32
    from zero and divided by their number (one microbatch: taken
    straight).  Peak activation memory scales down by the factor while the
    optimizer sees the same mean gradient."""
    k = max(cfg.n_microbatches, 1)
    if k == 1:
        return loss_and_grads(cfg, params, batch)
    rows = next(iter(batch.values())).shape[0]
    if rows % k:
        raise ValueError(f"global batch {rows} does not split into {k} "
                         f"microbatches")
    mb = rows // k
    device = optim.tree_leaves(params)[0].device
    gsum = optim.tree_map(lambda p: torch.zeros(
        p.shape, dtype=torch.float32, device=p.device), params)
    lsum = torch.zeros((), dtype=torch.float32, device=device)
    for i in range(k):
        micro = {key: v[i * mb:(i + 1) * mb] for key, v in batch.items()}
        loss_i, g = loss_and_grads(cfg, params, micro)
        optim.tree_map(torch.Tensor.add_, gsum, g)
        lsum = lsum + loss_i
        del g
    div = torch.full((), k, dtype=torch.float32, device=device)
    return lsum / div, optim.tree_map(lambda g: g / div, gsum)


def make_train_step(cfg: ModelConfig, ocfg: optim.AdamWConfig):
    """Train step: :func:`mean_loss_and_grads`, then one AdamW update."""

    def train_step(params, opt_state, batch):
        loss, grads = mean_loss_and_grads(cfg, params, batch)
        new_params, new_state, metrics = optim.update(ocfg, grads, opt_state,
                                                      params)
        metrics["loss"] = loss
        return new_params, new_state, metrics

    return train_step
