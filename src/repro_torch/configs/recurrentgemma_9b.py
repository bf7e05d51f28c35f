"""recurrentgemma-9b [hybrid]: 38L d_model=4096 16H (MQA kv=1)
d_ff=12288 vocab=256000 — RG-LRU + local attention, 2 recurrent : 1
local, window 2048 [arXiv:2402.19427].  38 = 12 groups of
(rglru, rglru, local) + a 2-rglru tail (exact layer count)."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid", n_layers=38, d_model=4096,
    n_heads=16, n_kv_heads=1, d_ff=12288, vocab=256000, head_dim=256,
    pattern=("rglru", "rglru", "local"), window=2048, mlp="swiglu",
    rnn_width=4096,
)

SMOKE_CONFIG = ModelConfig(
    name="recurrentgemma-smoke", family="hybrid", n_layers=5, d_model=64,
    n_heads=4, n_kv_heads=1, d_ff=128, vocab=128, head_dim=16,
    pattern=("rglru", "rglru", "local"), window=16, mlp="swiglu",
    rnn_width=64,
)
