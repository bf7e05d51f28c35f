"""Published peaks of one NVIDIA H100 SXM (NVIDIA's H100 data sheet,
dense rates without sparsity, at the full 700 W power limit).  A card
set below 700 W runs slower under load: the run prints its
``power.limit`` beside every share of these peaks."""

BF16_DENSE_FLOPS = 989e12     # FLOP/s, bf16 tensor cores, dense
HBM_BYTES_PER_S = 3.35e12     # B/s, HBM3
