"""Gradient compression with error feedback, after
``repro.optim.compress``: write-set sparsification.

In Pot terms, compressing a gradient transaction shrinks its write set
before commit.  Error feedback keeps the residual locally so the serial
semantics are preserved in expectation; the selection (top-k by
magnitude) is a function of the gradient alone, so the compressed
transaction is as deterministic as the uncompressed one.  Everything
here is exact arithmetic: the port's result is the reference's, bit for
bit.
"""

from __future__ import annotations

import torch

from repro_torch.tree import leaves, tree_map, unflatten


def error_feedback_init(params):
    """A float32 zero residual per parameter leaf."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _leaf(g: torch.Tensor, r: torch.Tensor, ratio: float):
    g = g.float() + r
    flat = g.reshape(-1)
    k = max(1, int(flat.numel() * ratio))
    # the k-th largest magnitude; ties with it are kept too, so more than
    # k entries may survive, as in the reference
    thresh = torch.topk(flat.abs(), k).values[-1]
    sparse = torch.where(g.abs() >= thresh, g, 0.0)
    return sparse, g - sparse


def topk_compress(grads, residual, *, ratio: float = 0.01):
    """Per-leaf magnitude top-k with error feedback.

    Returns ``(sparse_grads, new_residual)``: ``sparse_grads`` has the
    dense shapes with the entries not selected zeroed; ``new_residual``
    holds what was dropped."""
    out = [_leaf(g, r, ratio)
           for g, r in zip(leaves(grads), leaves(residual), strict=True)]
    return (unflatten(grads, [o[0] for o in out]),
            unflatten(grads, [o[1] for o in out]))
