"""stablelm-12b [dense]: 40L d_model=5120 32H (GQA kv=8) head_dim=160
d_ff=13824 vocab=100352, SwiGLU, untied lm_head
[hf:stabilityai/stablelm-2-12b]."""
from repro_torch.models.config import Block, ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b",
    family="dense",
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=160,
    d_ff=13824,
    vocab_size=100352,
    pattern=(Block("attn"),),
    n_periods=40,
    act="silu",
    glu=True,
    rope_theta=10000.0,
    tie_embeddings=False,
    n_microbatches=8,
)

SMOKE = CONFIG.scaled_down(
    n_microbatches=1,
    d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
    vocab_size=512, n_periods=2,
)
