"""granite-moe-3b-a800m [moe]: 32L d_model=1536 24H (GQA kv=8) expert
d_ff=512 vocab=49155, MoE 40 experts top-8, SwiGLU, tied embeddings
[hf:ibm-granite]."""
from repro_torch.models.config import Block, ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49155,
    pattern=(Block("attn", moe=True),),
    n_periods=32,
    act="silu",
    glu=True,
    rope_theta=10000.0,
    tie_embeddings=True,
    n_experts=40,
    top_k=8,
    d_ff_expert=512,
)

SMOKE = CONFIG.scaled_down(
    d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=96,
    vocab_size=512, n_periods=2, n_experts=8, top_k=2, d_ff_expert=96,
)
