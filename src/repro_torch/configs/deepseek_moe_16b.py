"""deepseek-moe-16b [moe]: 28L d_model=2048 16H (kv=16, MHA) d_ff=1408
per expert, vocab=102400, 64 routed experts top-6 + 2 shared
(fine-grained) [arXiv:2401.06066]."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b", family="moe", n_layers=28, d_model=2048,
    n_heads=16, n_kv_heads=16, d_ff=1408, vocab=102400,
    pattern=("attn",), mlp="swiglu",
    n_experts=64, top_k=6, n_shared_experts=2,
)

SMOKE_CONFIG = ModelConfig(
    name="deepseek-smoke", family="moe", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=4, d_ff=48, vocab=128,
    pattern=("attn",), mlp="swiglu",
    n_experts=8, top_k=3, n_shared_experts=2, capacity_factor=8.0,
)
