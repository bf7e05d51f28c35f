"""Optimizers and gradient commits of the training path, after
``repro.optim``: AdamW through the fused kernel, Adafactor, top-k
compression with error feedback, and the fixed-ring ordered reduction
across ranks (with its in-device pairwise tree)."""

from repro_torch.optim.adamw import adamw_init, adamw_update
from repro_torch.optim.adafactor import adafactor_init, adafactor_update
from repro_torch.optim.compress import error_feedback_init, topk_compress
from repro_torch.optim.ordered_reduce import (ordered_ring_reduce,
                                              ordered_ring_sum,
                                              ordered_tree_sum)

__all__ = [
    "adamw_init", "adamw_update", "adafactor_init", "adafactor_update",
    "topk_compress", "error_feedback_init", "ordered_ring_reduce",
    "ordered_ring_sum", "ordered_tree_sum",
]
