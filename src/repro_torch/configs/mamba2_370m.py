"""mamba2-370m [ssm]: 48L d_model=1024, attn-free (d_ff=0), vocab=50280,
ssm_state=128 — SSD (state-space duality) [arXiv:2405.21060]."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m", family="ssm", n_layers=48, d_model=1024,
    n_heads=32, n_kv_heads=32, d_ff=0, vocab=50280,
    pattern=("mamba",), mlp="none",
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_chunk=256,
)

SMOKE_CONFIG = ModelConfig(
    name="mamba2-smoke", family="ssm", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=4, d_ff=0, vocab=128,
    pattern=("mamba",), mlp="none",
    ssm_state=16, ssm_expand=2, ssm_head_dim=16, ssm_chunk=8,
)
