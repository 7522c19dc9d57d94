"""ExecContext: how GEMMs execute, and on which device entry points run.

Port of ``repro.core.context`` with ``backend``, ``tuning_table`` and
``force_mode``; the mesh waits for its ROADMAP item.  Two backends:
``"cuda"``, the counterpart of the reference's ``"pallas"``, sends every
quantized GEMM to the hand-written kernels (their plain PyTorch versions
when the tensors lie on the CPU), and a GEMM outside their windows or
bounds to the ATen route; ``"aten"``, the counterpart of the reference's
``"xla"``, runs every GEMM on the digit recursion of
:mod:`repro_torch.core.kmm` over exact ATen leaf products.  A tuning table (a
:class:`repro_torch.tune.table.TuningTable` or a path to one) is consulted
by plan selection; tables are numerics-pinned, so it takes no part in the
context's equality or hash.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Any, Optional

import torch

BACKENDS = ("cuda", "aten")
FORCE_MODES = ("auto", "mm2")


@dataclass(frozen=True)
class ExecContext:
    backend: str = "cuda"           # "cuda" | "aten"
    tuning_table: Optional[Any] = field(default=None, compare=False)
    force_mode: str = "auto"        # "auto" | "mm2" (conventional baseline)

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; "
                             f"choices {BACKENDS}")
        if self.force_mode not in FORCE_MODES:
            raise ValueError(f"unknown force_mode {self.force_mode!r}; "
                             f"choices {FORCE_MODES}")

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
