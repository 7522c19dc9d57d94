"""qwen3-moe-30b-a3b [moe]: 48L d_model=2048 32H (GQA kv=4) expert d_ff=768
vocab=151936, MoE 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B]."""
from repro_torch.models.config import Block, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=768,
    vocab_size=151936,
    pattern=(Block("attn", moe=True),),
    n_periods=48,
    act="silu",
    glu=True,
    rope_theta=1000000.0,
    tie_embeddings=False,
    n_experts=128,
    top_k=8,
    d_ff_expert=768,
    n_microbatches=8,
)

SMOKE = CONFIG.scaled_down(
    n_microbatches=1,
    d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=96,
    vocab_size=512, n_periods=2, n_experts=8, top_k=2, d_ff_expert=96,
)
