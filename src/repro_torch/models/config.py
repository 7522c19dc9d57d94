"""Model configuration (port of ``repro.models.config``: the dense, MoE,
mamba, RWKV, encoder-decoder and front-end fields).

A model is ``n_periods`` repetitions of a ``pattern`` of blocks; parameters
are stacked over periods.  The port serves attention, mamba and RWKV
blocks, each with a dense or an MoE MLP, a vision front end's prefix
(``frontend="vision"``) and an encoder-decoder (``encoder_periods`` > 0:
an encoder of the same pattern, cross-attention in every decoder block,
and, with ``frontend="audio"``, the frame projection in front of the
encoder), and the training fields (``remat``, ``n_microbatches``,
``bf16_cast_params``) that ``models.lm.loss_fn`` and
``launch.steps.make_train_step`` read.
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
    # Encoder-decoder
    encoder_periods: int = 0         # >0 => enc-dec; encoder uses `pattern`
    # Modality front-end stub ("none" | "vision" | "audio")
    frontend: str = "none"
    frontend_dim: int = 0            # embedding dim provided by the stub
    frontend_tokens: int = 0         # prefix tokens contributed at prefill
    quant: QuantConfig = QuantConfig()
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # Training: recompute each period's forward in the backward
    # (torch.utils.checkpoint), the reference's jax.checkpoint
    remat: bool = True
    # Gradient-accumulation microbatches of the full-size train shape; the
    # optimizer sees the mean gradient.  Serving ignores it.
    n_microbatches: int = 1
    # Cast fp32 weight matrices to bf16 before use in the train step (the
    # leaf rule is launch.steps.cast_params); fp32 master params stay in
    # the optimizer and gradients accumulate in fp32.
    bf16_cast_params: bool = True

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
    def is_encdec(self) -> bool:
        return self.encoder_periods > 0

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
