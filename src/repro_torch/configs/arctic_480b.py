"""arctic-480b [moe]: 35L d_model=7168 56H (GQA kv=8) d_ff=4864
vocab=32000, MoE 128 experts top-2 + dense residual FFN
[hf:Snowflake/snowflake-arctic-base]."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b", family="moe", n_layers=35, d_model=7168,
    n_heads=56, n_kv_heads=8, d_ff=4864, vocab=32000, head_dim=128,
    pattern=("attn",), mlp="swiglu",
    n_experts=128, top_k=2, dense_residual=True, residual_d_ff=4864,
)

SMOKE_CONFIG = ModelConfig(
    name="arctic-smoke", family="moe", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, d_ff=96, vocab=128, head_dim=16,
    pattern=("attn",), mlp="swiglu",
    n_experts=8, top_k=2, dense_residual=True, residual_d_ff=96,
)
