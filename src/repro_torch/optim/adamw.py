"""AdamW over the port's parameter trees, after ``repro.optim.adamw``.

The optimizer apply is the fast-mode direct commit: every leaf goes
through ``kernels.ops.adamw_update``, which runs the hand-written fused
kernel on the card (``csrc/fused_adamw.cu``) and its plain version on
the CPU.  The reference's docstring says that its TPU path swaps the
fused Pallas kernel in leaf by leaf; here that is the only path.

``step`` is a 0-d int32 tensor on the parameters' device.  The bias
corrections are computed from it there, in float32 (as the reference's
``_hp_vector`` computes them), so an apply never waits for the host.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.tree import leaves, tree_map, unflatten


def adamw_init(params) -> dict:
    """Zero moments (float32, one per parameter leaf) and step 0."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    first = leaves(params)[0]
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=first.device)}


def adamw_update(params, grads, state, *, lr=1e-3, b1=0.9, b2=0.999,
                 eps=1e-8, wd=0.01):
    """One AdamW step over float32 parameters: returns ``(params',
    state')``, new trees; the inputs are left as they were."""
    step = state["step"] + 1
    out = [ops.adamw_update(p, m, v, g, step=step, lr=lr, b1=b1, b2=b2,
                            eps=eps, wd=wd)
           for p, g, m, v in zip(leaves(params), leaves(grads),
                                 leaves(state["m"]), leaves(state["v"]))]
    p2, m2, v2 = zip(*out)
    return unflatten(params, p2), {"m": unflatten(params, m2),
                                   "v": unflatten(params, v2),
                                   "step": step}
