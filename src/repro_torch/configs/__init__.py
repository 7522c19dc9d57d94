"""Architecture registry: ``get_config(arch, smoke=False, quant=...)``.

The port registers the architectures it can serve: the dense
``llama3.2-1b``, ``gemma-2b``, ``stablelm-12b`` and ``nemotron-4-15b``, the
MoE ``granite-moe-3b-a800m`` and ``qwen3-moe-30b-a3b``, the hybrid
``jamba-v0.1-52b`` (mamba, attention and MoE), the attention-free
``rwkv6-3b``, the vision-language ``llava-next-mistral-7b`` (a projected
prefix of precomputed patch embeddings) and the encoder-decoder
``seamless-m4t-medium`` (projected fbank frames) — all ten of the
reference's architectures.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import Dict, Optional

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
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "seamless-m4t-medium": "seamless_m4t_medium",
}

QUANT_POLICIES = {
    "none": QuantConfig(),
    "w8": POLICY_W8,
    "w12": POLICY_W12,
    "mixed": POLICY_MIXED,
    # conventional 4-product digit GEMM at the same width: the paper's
    # baseline that KMM2's 3 products are measured against (every GEMM on
    # the ATen route's mm_n, as the reference's force_mode="mm2" runs)
    "w12-mm2": QuantConfig(enabled=True, default_bits=12, force_mode="mm2"),
}


@dataclass(frozen=True)
class ShapeCell:
    """A step's shape: ``kind`` is "train", "prefill" or "decode"."""
    name: str
    seq_len: int
    global_batch: int
    kind: str


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def cell_applicable(cfg: ModelConfig, shape: str) -> bool:
    """The reference's skip rule: the 500k-token decode cell only for
    sub-quadratic models."""
    cell = SHAPES[shape]
    if cell.name == "long_500k":
        return cfg.sub_quadratic
    return True


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
