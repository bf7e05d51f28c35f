"""internvl2-26b [vlm]: 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92553 — InternViT frontend is a STUB (input_specs provides
precomputed patch embeddings) + InternLM2-20B backbone
[arXiv:2404.16821]."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b", family="vlm", n_layers=48, d_model=6144,
    n_heads=48, n_kv_heads=8, d_ff=16384, vocab=92553,
    pattern=("attn",), mlp="swiglu", n_patches=256,
)

SMOKE_CONFIG = ModelConfig(
    name="internvl2-smoke", family="vlm", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, d_ff=128, vocab=128,
    pattern=("attn",), mlp="swiglu", n_patches=8,
)
