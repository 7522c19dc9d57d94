"""jamba-v0.1-52b [hybrid]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16e top-2, Mamba:attention 7:1 interleave
[arXiv:2403.19887].

One period = 8 layers: attention at offset 4 and mamba elsewhere, MoE on
every odd layer (the Jamba paper's layout).
"""
from repro_torch.models.config import Block, ModelConfig

_PERIOD = tuple(
    Block("attn" if i == 4 else "mamba", moe=(i % 2 == 1)) for i in range(8)
)

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    pattern=_PERIOD,
    n_periods=4,
    act="silu",
    glu=True,
    rope_theta=10000.0,
    tie_embeddings=False,
    n_experts=16,
    top_k=2,
    d_ff_expert=14336,
    d_state=16,
    conv_width=4,
    expand=2,
    n_microbatches=8,
)

SMOKE = CONFIG.scaled_down(
    n_microbatches=1,
    d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=96,
    vocab_size=512, n_periods=1, n_experts=4, top_k=2, d_ff_expert=96,
    d_state=8,
)
