"""seamless-m4t-medium [audio]: encoder-decoder, 12L enc + 12L dec,
d_model=1024 16H (kv=16) d_ff=4096 vocab=256206; speech frontend is a STUB —
the input spec provides precomputed fbank frame features (dim 160) projected
into the encoder stream [arXiv:2308.11596]."""
from repro_torch.models.config import Block, ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256206,
    pattern=(Block("attn"),),
    n_periods=12,            # decoder depth
    encoder_periods=12,      # encoder depth
    act="gelu",
    glu=False,
    rope_theta=10000.0,
    tie_embeddings=True,
    frontend="audio",
    frontend_dim=160,
    n_microbatches=2,
)

SMOKE = CONFIG.scaled_down(
    n_microbatches=1,
    d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
    vocab_size=512, n_periods=2, encoder_periods=2, frontend_dim=32,
)
