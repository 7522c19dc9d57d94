"""Architecture registry: ``get_config(arch, smoke=False, quant=...)``.

The port registers the architectures it can serve: the dense
``llama3.2-1b``, ``gemma-2b``, ``stablelm-12b`` and ``nemotron-4-15b``, the
MoE ``granite-moe-3b-a800m`` and the attention-free ``rwkv6-3b``.
"""
from __future__ import annotations

import importlib
from typing import Optional

from repro_torch.models.config import ModelConfig
from repro_torch.quant.policy import (POLICY_MIXED, POLICY_W12, POLICY_W8,
                                      QuantConfig)

_MODULES = {
    "llama3.2-1b": "llama3_2_1b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "rwkv6-3b": "rwkv6_3b",
    "gemma-2b": "gemma_2b",
    "stablelm-12b": "stablelm_12b",
    "nemotron-4-15b": "nemotron_4_15b",
}

QUANT_POLICIES = {
    "none": QuantConfig(),
    "w8": POLICY_W8,
    "w12": POLICY_W12,
    "mixed": POLICY_MIXED,
}


def list_archs():
    return sorted(_MODULES)


def get_config(arch: str, *, smoke: bool = False,
               quant: Optional[str] = None) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; choices: {list_archs()}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    cfg: ModelConfig = mod.SMOKE if smoke else mod.CONFIG
    if quant is not None:
        cfg = cfg.with_quant(QUANT_POLICIES[quant])
    return cfg
