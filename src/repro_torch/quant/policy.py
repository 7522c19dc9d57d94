"""Per-layer precision policy (port of ``repro.quant.policy``): a policy
assigns a bitwidth to every named matmul site, and the dispatch rule
(``core.dispatch``) turns that width into an execution mode.

The port mirrors the reference's ``mixed`` policy as it is: its patterns
``*o_proj`` and ``*router`` match no site of a dense model (the attention
output site is ``blkN.attn.wo``), so on a dense model w = 12 lands on
``lm_head`` only.
"""
from __future__ import annotations

import fnmatch
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class QuantConfig:
    """Quantized-execution configuration attached to a model config."""

    enabled: bool = False
    default_bits: int = 8
    m: int = 8                      # multiplier (tensor-core operand) bits
    # "cuda": the hand-written kernels (the ATen route where they cannot
    # take a GEMM); "aten": the reference's "xla", every GEMM on the
    # digit recursion over ATen leaf products
    backend: str = "cuda"
    force_mode: str = "auto"        # "auto" | "mm2"
    # fnmatch patterns on layer names -> bitwidth overrides
    overrides: Tuple[Tuple[str, int], ...] = ()

    def bits_for(self, name: str) -> int:
        for pattern, bits in self.overrides:
            if fnmatch.fnmatch(name, pattern):
                return bits
        return self.default_bits


POLICY_W8 = QuantConfig(enabled=True, default_bits=8)
POLICY_W12 = QuantConfig(enabled=True, default_bits=12)
POLICY_MIXED = QuantConfig(
    enabled=True, default_bits=8,
    overrides=(("*lm_head", 12), ("*o_proj", 12), ("*router", 12)),
)
# The (2m-2, 2m] boundary: every site runs the fused kernel's mm2 mode.
POLICY_W16 = QuantConfig(enabled=True, default_bits=16)
