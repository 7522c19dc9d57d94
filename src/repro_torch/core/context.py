"""ExecContext: how GEMMs execute, and on which device entry points run.

Port of ``repro.core.context`` with ``backend``, ``mesh``,
``tuning_table`` and ``force_mode``.  Two backends:
``"cuda"``, the counterpart of the reference's ``"pallas"``, sends every
quantized GEMM to the hand-written kernels (their plain PyTorch versions
when the tensors lie on the CPU), and a GEMM outside their windows or
bounds to the ATen route; ``"aten"``, the counterpart of the reference's
``"xla"``, runs every GEMM on the digit recursion of
:mod:`repro_torch.core.kmm` over exact ATen leaf products.  A tuning table (a
:class:`repro_torch.tune.table.TuningTable` or a path to one) is consulted
by plan selection; tables are numerics-pinned, so it takes no part in the
context's equality or hash.  ``mesh`` (a ``DeviceMesh`` from
:mod:`repro_torch.launch.mesh`) runs each GEMM on the ``"cuda"`` backend
shard-mapped over it (:mod:`repro_torch.dist.shard_gemm`); None runs it on
this rank alone.
"""
from __future__ import annotations

import contextlib
import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple

import torch

BACKENDS = ("cuda", "aten")
FORCE_MODES = ("auto", "mm2")


@dataclass(frozen=True)
class ExecContext:
    backend: str = "cuda"           # "cuda" | "aten"
    mesh: Optional[Any] = None      # a DeviceMesh, or None
    tuning_table: Optional[Any] = field(default=None, compare=False)
    force_mode: str = "auto"        # "auto" | "mm2" (conventional baseline)

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; "
                             f"choices {BACKENDS}")
        if self.force_mode not in FORCE_MODES:
            raise ValueError(f"unknown force_mode {self.force_mode!r}; "
                             f"choices {FORCE_MODES}")

    def replace(self, **kw) -> "ExecContext":
        return dataclasses.replace(self, **kw)

    def local_gemm_shape(self, shape: Tuple[int, int, int]
                         ) -> Tuple[int, int, int]:
        """Per-rank (M, K, N) of a GEMM under this context's mesh (M over
        the data axes, N over ``model``, K replicated); the shape itself
        without a mesh."""
        if self.mesh is None:
            return shape
        from repro_torch.tune.space import local_shape
        return local_shape(shape, self.mesh)

    def resolve_table(self):
        """The context's table as a loaded TuningTable (a path is loaded on
        each call: pass the loaded object where that matters), or None."""
        if self.tuning_table is None:
            return None
        from repro_torch.tune.table import TuningTable
        if isinstance(self.tuning_table, TuningTable):
            return self.tuning_table
        return TuningTable.load(self.tuning_table)

    def activate(self):
        """Context manager installing ``tuning_table`` as the process-wide
        active table for the enclosed calls; a no-op without a table."""
        if self.tuning_table is None:
            return contextlib.nullcontext()
        from repro_torch.tune.table import use_table
        return use_table(self.tuning_table)


def resolve_context(context: Optional[ExecContext], *, what: str,
                    mesh: Optional[Any] = None,
                    _defaults: Optional[ExecContext] = None) -> ExecContext:
    """``context`` (else ``_defaults``, else ``ExecContext()``) with
    ``mesh`` folded in.  The reference's shim also folds its deprecated
    kwargs; the port has none of them, so ``mesh`` is what is left.  A
    ``mesh`` that disagrees with ``context.mesh`` raises."""
    base = context if context is not None else (
        _defaults if _defaults is not None else ExecContext())
    if mesh is None:
        return base
    if base.mesh is not None and base.mesh is not mesh:
        raise ValueError(f"{what}: mesh= and context.mesh disagree; set one "
                         f"of them")
    return base.replace(mesh=mesh)


def resolve_device(device: Optional[str | torch.device] = None
                   ) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU.  There is no automatic CPU fallback — asking for CUDA on a
    machine without it raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but torch.cuda is not "
                           "available; pass device='cpu' to run on the CPU")
    return dev
