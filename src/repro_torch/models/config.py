"""Model configuration (port of ``repro.models.config``, the dense, MoE,
mamba and RWKV fields).

A model is ``n_periods`` repetitions of a ``pattern`` of blocks; parameters
are stacked over periods.  The port serves attention, mamba and RWKV
blocks, each with a dense or an MoE MLP; the fields of the other families
(encoder-decoder, modality front ends) and of training wait for their
ROADMAP items.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Tuple

from repro_torch.quant.policy import QuantConfig


@dataclass(frozen=True)
class Block:
    kind: str = "attn"        # "attn" | "mamba" | "rwkv"
    moe: bool = False         # MoE MLP instead of dense MLP


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    pattern: Tuple[Block, ...]
    n_periods: int
    act: str = "silu"                # silu | gelu | relu2
    glu: bool = True                 # gated MLP (SwiGLU/GeGLU)
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    # MoE
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    # SSM (mamba)
    d_state: int = 16
    conv_width: int = 4
    expand: int = 2
    # RWKV
    rwkv_head_dim: int = 64
    quant: QuantConfig = QuantConfig()
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # Gradient-accumulation microbatches of the reference's full-size train
    # shape; serving ignores it (the configs carry it as the reference's
    # do, for the training item).
    n_microbatches: int = 1

    @property
    def n_layers(self) -> int:
        return len(self.pattern) * self.n_periods

    @property
    def padded_vocab(self) -> int:
        """Embedding rows padded to a multiple of 512; logits beyond
        ``vocab_size`` are masked in the head."""
        return -(-self.vocab_size // 512) * 512

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def attn_free(self) -> bool:
        return all(b.kind != "attn" for b in self.pattern)

    @property
    def sub_quadratic(self) -> bool:
        """True where a block carries recurrent state (mamba, rwkv): decode
        cost per token does not grow with the sequence."""
        return any(b.kind in ("mamba", "rwkv") for b in self.pattern)

    def with_quant(self, quant: QuantConfig) -> "ModelConfig":
        return replace(self, quant=quant)

    def scaled_down(self, **kw) -> "ModelConfig":
        """Reduced config of the same family (tests, smoke runs)."""
        return replace(self, **kw)
