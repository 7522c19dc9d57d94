"""ExecContext: how GEMMs execute, and on which device entry points run.

Port of ``repro.core.context`` with ``backend`` and ``force_mode`` only; the
mesh and tuning-table fields wait for their ROADMAP items.  The port has one
backend, ``"cuda"`` — the counterpart of the reference's ``"pallas"``: every
quantized GEMM goes to the hand-written fused kernel (its plain PyTorch
version when the tensors lie on the CPU).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

BACKENDS = ("cuda",)
FORCE_MODES = ("auto", "mm2")


@dataclass(frozen=True)
class ExecContext:
    backend: str = "cuda"
    force_mode: str = "auto"        # "auto" | "mm2" (conventional baseline)

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; "
                             f"choices {BACKENDS}")
        if self.force_mode not in FORCE_MODES:
            raise ValueError(f"unknown force_mode {self.force_mode!r}; "
                             f"choices {FORCE_MODES}")


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
