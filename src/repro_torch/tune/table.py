"""Persisted per-(backend, M/K/N bucket, bitwidth) tuning tables (port of
``repro.tune.table``).

A table maps a GEMM problem key to the measured winner
:class:`~repro_torch.core.dispatch.ExecPlan` of :mod:`repro_torch.tune
.runner`.  The JSON layout, ``TABLE_VERSION`` and key format are the
reference's, with backend ``cuda``:

    {
      "version": 1,
      "device": "cuda/NVIDIA H100 80GB HBM3",
      "entries": {
        "cuda/m8/k2048/n8192/w12/mult8": {
          "variant": "kmm2", "block_k": 256, "combine_int32": false,
          "depth": 1, "us": 61.2, "us_default": 70.3, "n_candidates": 24
        }
      }
    }

Entries carry ``block_k`` as their only tile; a reference table's
``block_m``/``block_n`` are read and ignored.  Lookups bucket M/K/N to
powers of two (``space.bucket_shape``).  The process-wide *active table*
is what plan selection consults when the caller passes none; install one
with ``set_active_table(path_or_table)`` or scoped with ``use_table``.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
from dataclasses import dataclass, field
from typing import Dict, Optional, Union

from repro_torch.core.dispatch import ExecPlan
from repro_torch.tune.space import Shape, bucket_shape

TABLE_VERSION = 1
DEFAULT_DIR = "tuned"
DEFAULT_PATH = os.path.join(DEFAULT_DIR, "h100.json")

_ENTRY_FIELDS = ("variant", "block_k", "combine_int32", "depth")


def key_for(backend: str, shape: Shape, w: int, m: int = 8) -> str:
    """Table key; includes the multiplier bitwidth ``m`` so sweeps at
    different multiplier widths never collide."""
    mb, kb, nb = bucket_shape(shape)
    return f"{backend}/m{mb}/k{kb}/n{nb}/w{w}/mult{m}"


@dataclass
class TuningTable:
    """In-memory tuning table; ``entries`` maps key -> plain-dict record.
    ``plans`` memoizes the plan the quantized matmul resolves per (M, K, N,
    w, m) under this table (the port has no trace cache to hold it); any
    change to the entries clears it."""

    entries: Dict[str, dict] = field(default_factory=dict)
    device: str = ""
    meta: Dict[str, str] = field(default_factory=dict)
    plans: Dict[tuple, object] = field(default_factory=dict, repr=False,
                                       compare=False)

    def lookup(self, backend: str, shape: Shape, w: int,
               m: int = 8) -> Optional[ExecPlan]:
        rec = self.entries.get(key_for(backend, shape, w, m))
        if rec is None:
            return None
        try:
            return ExecPlan(
                variant=str(rec["variant"]), w=w, m=m, backend=backend,
                block_k=int(rec["block_k"]),
                combine_int32=bool(rec["combine_int32"]),
                depth=int(rec.get("depth", 1)), source="table")
        except (KeyError, TypeError, ValueError):
            return None            # malformed entry: treat as missing

    def put(self, backend: str, shape: Shape, w: int, plan: ExecPlan,
            **extra) -> str:
        key = key_for(backend, shape, w, plan.m)
        rec = {f: getattr(plan, f) for f in _ENTRY_FIELDS}
        rec.update({k: v for k, v in extra.items() if v is not None})
        self.entries[key] = rec
        self.plans.clear()
        return key

    def __len__(self) -> int:
        return len(self.entries)

    def save(self, path: Union[str, os.PathLike]) -> None:
        d = os.path.dirname(str(path))
        if d:
            os.makedirs(d, exist_ok=True)
        doc = {"version": TABLE_VERSION, "device": self.device,
               "meta": self.meta,
               "entries": {k: self.entries[k] for k in sorted(self.entries)}}
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: Union[str, os.PathLike]) -> "TuningTable":
        with open(path) as f:
            doc = json.load(f)
        if int(doc.get("version", 0)) != TABLE_VERSION:
            raise ValueError(
                f"tuning table {path}: version {doc.get('version')!r} "
                f"unsupported (want {TABLE_VERSION})")
        entries = doc.get("entries", {})
        if not isinstance(entries, dict):
            raise ValueError(f"tuning table {path}: 'entries' must be a dict")
        return cls(entries=dict(entries), device=str(doc.get("device", "")),
                   meta=dict(doc.get("meta", {})))


# The process-wide registry plan selection consults.
_LOCK = threading.Lock()
_ACTIVE: Optional[TuningTable] = None


def set_active_table(
        table: Optional[Union[TuningTable, str, os.PathLike]]) -> None:
    """Install (or clear, with None) the process-wide tuning table: a
    loaded :class:`TuningTable` or a path to a JSON table."""
    global _ACTIVE
    if table is not None and not isinstance(table, TuningTable):
        table = TuningTable.load(table)
    with _LOCK:
        _ACTIVE = table


def get_active_table() -> Optional[TuningTable]:
    return _ACTIVE


@contextlib.contextmanager
def use_table(table: Optional[Union[TuningTable, str, os.PathLike]]):
    """Scoped ``set_active_table`` (restores the previous table on exit)."""
    prev = get_active_table()
    set_active_table(table)
    try:
        yield get_active_table()
    finally:
        set_active_table(prev)
