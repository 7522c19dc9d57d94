"""nemotron-4-15b [dense]: 32L d_model=6144 48H (GQA kv=8) head_dim=128
d_ff=24576 vocab=256000, squared-ReLU (no GLU), untied lm_head
[arXiv:2402.16819]."""
from repro_torch.models.config import Block, ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=256000,
    pattern=(Block("attn"),),
    n_periods=32,
    act="relu2",
    glu=False,
    rope_theta=10000.0,
    tie_embeddings=False,
    n_microbatches=8,
)

SMOKE = CONFIG.scaled_down(
    n_microbatches=1,
    d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
    vocab_size=512, n_periods=2,
)
