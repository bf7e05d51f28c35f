"""Named spans of the training step, for ``torch.profiler``.

``span(name)`` is a context manager.  While no profiler runs it is one
shared ``contextlib.nullcontext()``, so a span costs one check of the
profiler's state; under a profiler it is
``torch.profiler.record_function(name)``, which the profiler keeps and
writes into its Chrome trace on its own clock, beside the host
operations and the device kernels they launch.  There is no setting:
any ``torch.profiler`` session around training code records the spans.

The spans open in forward code only.  A kernel launched inside a span
belongs to it, and so does a backward kernel whose autograd node a
forward operation inside it created (the profiler links the two by the
node's forward thread and sequence number).  Under remat the forward
code runs again inside the backward pass, and opens its spans again.
Spans nest: the shared experts of a MoE layer are ``mlp_apply`` calls,
so their path is ``pot.moe`` then ``pot.mlp``.

Names and what each covers:

- ``pot.attn``: ``blocks.attn_apply``, the whole body: projections,
  RoPE, scores, softmax, the output projection; self- and
  cross-attention.
- ``pot.mlp``: ``blocks.mlp_apply``, the dense SwiGLU (or GELU) MLP.
- ``pot.moe``: ``moe.moe_apply``, routed and shared experts and the
  dense residual, on the dense and the expert-parallel path.
- ``pot.moe.route``: ``moe.route``, the router's product, softmax, sort
  and renormalised gates.
- ``pot.moe.dispatch``: ``moe.sort_by_expert``, ``moe.dispatch_positions``
  and ``moe.dispatch`` together: the sort by expert, each assignment's
  slot and the gather into (E, cap, D).
- ``pot.moe.experts``: ``moe.expert_ffn``, the three capacity-padded
  ``bmm`` and the SwiGLU.
- ``pot.moe.combine``: ``moe.combine``, the gather back, the gates and
  the sum over k.
- ``pot.logits``: ``lm._logits``, the final norm and the head's product.
- ``pot.loss``: ``train_step.loss_fn`` from the logits' cast to float32
  to the mean.
- ``pot.grad_sum``: ``train_step._accumulate``'s ordered commit of the
  microbatch transactions: the zeroed float32 sums, each microbatch's
  fixed-order adds and the final division.
- ``pot.commit``: the optimizer's apply in every training step (the
  fused AdamW launches, or Adafactor).

The exchanges of expert parallelism run between the ``pot.moe`` sub-spans,
inside ``pot.moe``.
"""

from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager that records the span ``name`` under a running
    profiler, and does nothing otherwise."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name)
