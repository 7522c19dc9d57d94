"""gemma-2b [dense]: 18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=256000,
GeGLU, head_dim=256, tied embeddings [arXiv:2403.08295]."""
from repro_torch.models.config import Block, ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b",
    family="dense",
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=256000,
    pattern=(Block("attn"),),
    n_periods=18,
    act="gelu",
    glu=True,
    rope_theta=10000.0,
    tie_embeddings=True,
    n_microbatches=2,
)

SMOKE = CONFIG.scaled_down(
    n_microbatches=1,
    d_model=64, n_heads=4, n_kv_heads=1, head_dim=16, d_ff=128,
    vocab_size=512, n_periods=2,
)
