"""llava-next-mistral-7b [vlm]: Mistral-7B backbone, 32L d_model=4096 32H
(GQA kv=8) d_ff=14336 vocab=32000; anyres vision frontend is a STUB — the
input spec provides precomputed CLIP patch embeddings (dim 1024) which a
2-layer GELU projector maps into the LM stream
[hf:llava-hf/llava-v1.6-mistral-7b-hf]."""
from repro_torch.models.config import Block, ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    pattern=(Block("attn"),),
    n_periods=32,
    act="silu",
    glu=True,
    rope_theta=1000000.0,
    tie_embeddings=False,
    frontend="vision",
    frontend_dim=1024,
    frontend_tokens=576,
    n_microbatches=8,
)

SMOKE = CONFIG.scaled_down(
    n_microbatches=1,
    d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
    vocab_size=512, n_periods=2, frontend_dim=32, frontend_tokens=8,
)
