"""starcoder2-15b [dense]: 40L d_model=6144 48H (GQA kv=4) d_ff=24576
vocab=49152 — GQA, RoPE [arXiv:2402.19173]; GELU MLP."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b", family="dense", n_layers=40, d_model=6144,
    n_heads=48, n_kv_heads=4, d_ff=24576, vocab=49152,
    pattern=("attn",), mlp="gelu",
)

SMOKE_CONFIG = ModelConfig(
    name="starcoder2-smoke", family="dense", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, d_ff=128, vocab=128,
    pattern=("attn",), mlp="gelu",
)
