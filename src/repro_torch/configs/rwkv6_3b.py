"""rwkv6-3b [ssm]: 32L d_model=2560 (attention-free) d_ff=8960 vocab=65536 —
Finch, data-dependent decay [arXiv:2404.05892].

Channel-mix FFN modeled as a squared-ReLU MLP (RWKV's channel mix uses
relu^2); time mix is the RWKV6 matrix-state recurrence in models/rwkv.py.
"""
from repro_torch.models.config import Block, ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    d_model=2560,
    n_heads=40,            # d_model / rwkv_head_dim; informational
    n_kv_heads=40,
    head_dim=64,
    d_ff=8960,
    vocab_size=65536,
    pattern=(Block("rwkv"),),
    n_periods=32,
    act="relu2",
    glu=False,
    tie_embeddings=False,
    rwkv_head_dim=64,
    n_microbatches=4,
)

SMOKE = CONFIG.scaled_down(
    n_microbatches=1,
    d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
    vocab_size=512, n_periods=2, rwkv_head_dim=16,
)
