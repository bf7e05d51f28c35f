"""whisper-medium [audio]: 24 enc + 24 dec layers, d_model=1024 16H
(kv=16) d_ff=4096 vocab=51865 — enc-dec; conv frontend is a STUB
(input_specs provides precomputed frame embeddings) [arXiv:2212.04356]."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", family="encdec", n_layers=24, d_model=1024,
    n_heads=16, n_kv_heads=16, d_ff=4096, vocab=51865,
    pattern=("attn",), mlp="gelu", encoder_layers=24, n_frames=1504,
)

SMOKE_CONFIG = ModelConfig(
    name="whisper-smoke", family="encdec", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=4, d_ff=128, vocab=128,
    pattern=("attn",), mlp="gelu", encoder_layers=2, n_frames=16,
)
