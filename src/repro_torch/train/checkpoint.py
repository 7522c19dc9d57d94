"""Atomic, async checkpoints with auto-resume (port of
``repro.train.checkpoint``), in the reference's on-disk layout.

Layout: ``<dir>/step_<N:08d>/arrays.npz`` + ``manifest.json`` ({"step",
"time", "n_arrays", meta...}), written to a temporary directory and
``os.replace``d into place, so a crash mid-save never corrupts the latest
checkpoint.  Arrays are keyed by their tree path joined with ``||``: a
dict key by its name, a tuple or list entry by its index, a NamedTuple's
field (the optimizer state's ``step``, ``mu``, ``nu``) by its name, so a
``(params, opt_state)`` pair is stored under ``0||embed``, ``1||step``,
``1||mu||embed``, ... as the reference stores it.

``AsyncCheckpointer`` copies the tree to host memory in ``save`` and
serializes it on a worker thread; ``wait()`` joins before the next save or
on shutdown (at most one in flight).

Under a mesh (a tree of each rank's blocks, ``lm.init_params(mesh=...)``)
arrays are still saved in the logical, unsharded layout, so a restart may
use another mesh shape (the reference's elastic scaling).
``AsyncCheckpointer(mesh=...)`` gathers each DTensor leaf to the writer
rank (world rank 0), leaf by leaf: every rank sends its block there in one
collective on its main thread, and the writer alone puts the blocks
together in host memory and writes them on its worker thread.
:func:`load` reads one leaf at a time and keeps each rank's block of it as
the like leaf holds its own (any mesh); every rank reads the directory, so
ranks on several hosts need it on storage they share.  ``latest_step(mesh=...)`` is read
by rank 0 and broadcast, so every rank resumes at the same step.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.bridge import array_to_numpy, array_to_torch
from repro_torch.dist import collectives as C
from repro_torch.dist import sharding as S

Params = Any

_SEP = "||"


def _items(tree, path=()):
    """(path, leaf) of every leaf, dict keys in sorted order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], path + (str(k),))
    elif hasattr(tree, "_fields"):                      # NamedTuple
        for name in tree._fields:
            yield from _items(getattr(tree, name), path + (name,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _items(v, path + (str(i),))
    else:
        yield path, tree


def _rebuild(tree, fn, path=()):
    if isinstance(tree, dict):
        return {k: _rebuild(v, fn, path + (str(k),)) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(getattr(tree, n), fn, path + (n,))
                            for n in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, fn, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _host(leaf) -> np.ndarray:
    """A host copy of an unsharded ``leaf`` (a CPU tensor's numpy view is
    copied, so a later in-place update cannot reach a pending save)."""
    if isinstance(leaf, torch.Tensor):
        arr = array_to_numpy(leaf)
        return arr.copy() if leaf.device.type == "cpu" else arr
    return np.array(leaf)


def _gather_to_writer(leaf) -> Optional[np.ndarray]:
    """A DTensor leaf whole on the writer (world rank 0) as a host array;
    None on the other ranks.  Every rank's block goes to the writer in one
    gather (a collective: every rank joins it), which places each block
    by its rank's mesh coordinate; no rank holds the whole leaf on its
    device."""
    mesh = leaf.device_mesh
    parts = C.gather_to_first(S.local(leaf))
    if parts is None:
        return None
    whole = torch.empty(tuple(leaf.shape), dtype=leaf.dtype)
    spec = S.dtensor_spec(leaf)
    for rank, part in enumerate(parts):
        S.local_block(whole, spec, mesh,
                      S.rank_coordinate(mesh, rank)).copy_(part)
    return array_to_numpy(whole)


def _flatten(tree: Params) -> Dict[str, np.ndarray]:
    return {_SEP.join(path): _host(leaf) for path, leaf in _items(tree)}


def save(ckpt_dir: str, step: int, tree: Params,
         meta: Optional[Dict[str, Any]] = None) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    flat = _flatten(tree)
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_save_")
    try:
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        manifest = {"step": int(step), "time": time.time(),
                    "n_arrays": len(flat), **(meta or {})}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        final = os.path.join(ckpt_dir, f"step_{step:08d}")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        return final
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def _writer(mesh) -> bool:
    """Whether this rank writes (rank 0 of a mesh's world; always
    without one)."""
    import torch.distributed as dist
    return mesh is None or dist.get_rank() == 0


def latest_step(ckpt_dir: str, mesh=None) -> Optional[int]:
    """The newest complete checkpoint's step, or None.  With ``mesh`` rank
    0 reads the directory and every rank gets its answer."""
    if mesh is not None:
        import torch.distributed as dist
        mine = latest_step(ckpt_dir) if _writer(mesh) else None
        device = "cpu" if dist.get_backend() == "gloo" else \
            mesh.device_type
        t = torch.tensor([-1 if mine is None else mine], dtype=torch.int64,
                         device=device)
        dist.broadcast(t, src=0)
        return None if int(t[0]) < 0 else int(t[0])
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(ckpt_dir, name,
                                             "manifest.json")):
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


def load(ckpt_dir: str, tree_like: Params, step: Optional[int] = None
         ) -> Tuple[int, Params, Dict[str, Any]]:
    """Restore into the structure of ``tree_like``: each leaf as a tensor
    of the like leaf's dtype on its device (a numpy like leaf stays
    numpy)."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)

    def put(npz, key_path, like):
        key = _SEP.join(key_path)
        arr = npz[key]
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"checkpoint shape mismatch at {key}: "
                             f"{arr.shape} vs {tuple(like.shape)}")
        if S.is_dtensor(like):
            # this rank's block of the logical array, as like holds its own
            block = S.local_block(array_to_torch(arr), S.dtensor_spec(like),
                                  like.device_mesh)
            block = block.to(S.local(like).device, like.dtype, copy=True)
            return S.like(like, block)
        if isinstance(like, torch.Tensor):
            return array_to_torch(arr, like.device).to(like.dtype)
        return arr

    with np.load(os.path.join(path, "arrays.npz")) as npz:
        tree = _rebuild(tree_like, lambda kp, like: put(npz, kp, like))
    return step, tree, manifest


def prune(ckpt_dir: str, keep: int = 3) -> None:
    """Delete all but the newest ``keep`` checkpoints."""
    if not os.path.isdir(ckpt_dir):
        return
    names = sorted(n for n in os.listdir(ckpt_dir)
                   if re.fullmatch(r"step_\d+", n))
    for name in names[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, name), ignore_errors=True)


class AsyncCheckpointer:
    """One-in-flight async saver (serialize on a worker thread).  With
    ``mesh`` each DTensor leaf is gathered here to the writer rank, which
    alone keeps the host copies and writes."""

    def __init__(self, ckpt_dir: str, keep: int = 3, mesh=None):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self.mesh = mesh
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, tree: Params,
             meta: Optional[Dict[str, Any]] = None) -> None:
        self.wait()
        writer = _writer(self.mesh)

        def host(_, leaf):
            if S.is_dtensor(leaf):
                return _gather_to_writer(leaf)
            return _host(leaf) if writer else None

        host_tree = _rebuild(tree, host)
        if not writer:
            return

        def work():
            try:
                save(self.ckpt_dir, step, host_tree, meta)
                prune(self.ckpt_dir, self.keep)
            except BaseException as e:   # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
