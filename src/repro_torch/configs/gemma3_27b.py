"""gemma3-27b [dense]: 62L d_model=5376 32H (GQA kv=16) d_ff=21504
vocab=262144 — 5:1 local:global sliding-window pattern, window=1024,
128k design context.  62 = 10 groups of (5 local + 1 global) + a
2-local-layer tail (exact layer count preserved via the tail mechanism,
models/lm.py)."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b", family="dense", n_layers=62, d_model=5376,
    n_heads=32, n_kv_heads=16, d_ff=21504, vocab=262144, head_dim=128,
    pattern=("local", "local", "local", "local", "local", "attn"),
    window=1024, mlp="swiglu", rope_theta=1_000_000.0,
)

SMOKE_CONFIG = ModelConfig(
    name="gemma3-smoke", family="dense", n_layers=8, d_model=64,
    n_heads=4, n_kv_heads=2, d_ff=128, vocab=128, head_dim=16,
    pattern=("local", "local", "local", "local", "local", "attn"),
    window=16, mlp="swiglu",
)
