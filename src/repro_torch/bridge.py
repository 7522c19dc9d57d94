"""numpy <-> torch bridge for parameter and cache trees.

Tests carry the reference package's parameters into the port so both
compute the same function: the caller turns the reference's arrays into
numpy (``jax.tree.map(np.asarray, params)``) and this module turns numpy
into torch.  It takes and returns numpy only, so it needs no JAX.

Under a mesh the trees cross in the logical layout: ``params_from_jax``
and ``opt_state_from_jax`` with ``mesh`` keep each rank's block of every
leaf under ``dist.sharding.leaf_spec`` (``shard_params``: only the blocks
reach the device), and ``tree_to_numpy`` / ``opt_state_to_numpy`` gather
a sharded tree whole (a collective on every rank), so a test can feed
the reference's params and AdamW state to a sharded run and compare what
comes back.

bfloat16 goes through its bits: numpy holds it as ``ml_dtypes.bfloat16``,
which torch cannot read, so the array is viewed as ``uint16`` (as int16 for
torch), copied, and viewed back as ``torch.bfloat16``.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch


def _is_bf16(arr: np.ndarray) -> bool:
    return arr.dtype.name == "bfloat16"


def array_to_torch(arr, device=None) -> torch.Tensor:
    arr = np.asarray(arr)
    if _is_bf16(arr):
        bits = np.ascontiguousarray(arr).view(np.uint16).view(np.int16)
        t = torch.from_numpy(bits.copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    return t.to(device) if device is not None else t


def array_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy, whole (a DTensor is gathered: a collective)."""
    from repro_torch.dist.sharding import full_leaf
    t = full_leaf(t).detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes     # numpy's bfloat16 type, shipped with JAX's deps
        return t.view(torch.int16).numpy().view(np.uint16).view(
            ml_dtypes.bfloat16)
    return t.numpy()


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def params_from_jax(tree: Any, device=None, mesh=None) -> Any:
    """A tree of numpy arrays (the reference's params or cache, converted
    with ``np.asarray``) -> the same tree of torch tensors on ``device``;
    with ``mesh``, each rank's blocks of a parameter tree."""
    if mesh is None:
        return tree_map(lambda a: array_to_torch(a, device), tree)
    from repro_torch.dist.sharding import shard_params
    return shard_params(tree_map(array_to_torch, tree), mesh,
                        device if device is not None else "cpu")


def tree_to_numpy(tree: Any) -> Any:
    """The reverse, for comparing caches: torch tensors -> numpy arrays
    (bfloat16 as ``ml_dtypes.bfloat16``)."""
    return tree_map(array_to_numpy, tree)


def opt_state_from_jax(state: Any, device=None, mesh=None):
    """The reference's AdamW state, converted with ``jax.tree.map(
    np.asarray, state)`` (anything with ``step``, ``mu`` and ``nu``, or a
    (step, mu, nu) tuple) -> the port's ``train.optim.OptState`` on
    ``device``; with ``mesh`` mu and nu held as their parameters' blocks."""
    from repro_torch.train.optim import OptState

    step, mu, nu = ((state.step, state.mu, state.nu)
                    if hasattr(state, "step") else state)
    return OptState(step=array_to_torch(np.asarray(step, np.int32), device),
                    mu=params_from_jax(mu, device, mesh),
                    nu=params_from_jax(nu, device, mesh))


def opt_state_to_numpy(state: Any):
    """The port's ``OptState`` -> a (step, mu, nu) tuple of numpy arrays,
    which the reference's ``OptState(*...)`` takes."""
    return (array_to_numpy(state.step), tree_to_numpy(state.mu),
            tree_to_numpy(state.nu))
