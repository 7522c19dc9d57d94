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
    """A host copy of ``leaf`` (a CPU tensor's numpy view is copied, so a
    later in-place update cannot reach a pending save)."""
    if isinstance(leaf, torch.Tensor):
        arr = array_to_numpy(leaf)
        return arr.copy() if leaf.device.type == "cpu" else arr
    return np.array(leaf)


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


def latest_step(ckpt_dir: str) -> Optional[int]:
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
    with np.load(os.path.join(path, "arrays.npz")) as npz:
        flat = {k: npz[k] for k in npz.files}

    def put(key_path, like):
        key = _SEP.join(key_path)
        arr = flat[key]
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"checkpoint shape mismatch at {key}: "
                             f"{arr.shape} vs {tuple(like.shape)}")
        if isinstance(like, torch.Tensor):
            return array_to_torch(arr, like.device).to(like.dtype)
        return arr

    return step, _rebuild(tree_like, put), manifest


def prune(ckpt_dir: str, keep: int = 3) -> None:
    """Delete all but the newest ``keep`` checkpoints."""
    if not os.path.isdir(ckpt_dir):
        return
    names = sorted(n for n in os.listdir(ckpt_dir)
                   if re.fullmatch(r"step_\d+", n))
    for name in names[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, name), ignore_errors=True)


class AsyncCheckpointer:
    """One-in-flight async saver (serialize on a worker thread)."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, tree: Params,
             meta: Optional[Dict[str, Any]] = None) -> None:
        self.wait()
        host_tree = _rebuild(tree, lambda _, leaf: _host(leaf))

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
