"""llama3.2-1b [dense]: 16L d_model=2048 32H (GQA kv=8) d_ff=8192
vocab=128256, SwiGLU, tied embeddings [hf:meta-llama/Llama-3.2-1B]."""
from repro_torch.models.config import Block, ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-1b",
    family="dense",
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    vocab_size=128256,
    pattern=(Block("attn"),),
    n_periods=16,
    act="silu",
    glu=True,
    rope_theta=500000.0,
    tie_embeddings=True,
    n_microbatches=2,
)

SMOKE = CONFIG.scaled_down(
    n_microbatches=1,
    d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
    vocab_size=512, n_periods=2,
)
