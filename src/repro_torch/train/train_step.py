"""Training step: baseline (traditional) vs Pot (preordered commits),
after ``repro.train.train_step``.

Gradient application is the framework's highest-volume transaction.  Two
step flavours:

- ``baseline``: one gradient of the whole batch, applied once.
- ``pot``: every microbatch gradient is a preordered transaction.  The
  microbatch gradients accumulate in float32 in sequence order, one
  fixed-order add per microbatch, so the sum, and with it the trained
  weights, is bitwise reproducible.  The optimizer apply is the
  fast-mode direct commit (``optim.adamw_update``, one fused-kernel
  launch per leaf on the card), and ``gv`` stamps the commit: a
  checkpoint restart resumes the same serialization order
  (``ckpt/checkpoint.py``).

Parameters are float32 master weights; the model casts them to bf16 at
use.  A step returns ``(new_state, loss)`` and leaves the state it was
given as it was.  The reference's sharding hooks (``prof``,
``grad_specs``) are identities on one card and are left out; the
multi-device ``make_pot_dp_step`` (fixed-ring reduction across shards),
Adafactor and the encoder (whisper) are not ported yet (ROADMAP queue 1
item 12).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import torch

from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw_init, adamw_update
from repro_torch.tree import leaves, tree_map, unflatten


def _adamw_only(optimizer: str) -> None:
    if optimizer != "adamw":
        raise NotImplementedError(
            f"optimizer {optimizer!r} is not ported yet (ROADMAP queue 1 "
            f"item 12); the port trains with 'adamw'")


@dataclasses.dataclass
class TrainState:
    params: dict
    opt: dict
    gv: torch.Tensor     # () int32: global version (last committed txn)
    step: torch.Tensor   # () int32


def init_state(params, optimizer="adamw") -> TrainState:
    _adamw_only(optimizer)
    opt = adamw_init(params)
    zero = lambda: torch.zeros((), dtype=torch.int32,
                               device=opt["step"].device)
    return TrainState(params=params, opt=opt, gv=zero(), step=zero())


def loss_fn(params, batch, cfg: ModelConfig, *, chunk=0, remat=True):
    """Next-token cross-entropy, averaged over the labels >= 0.  batch:
    {tokens (B, S), labels (B, S)} plus optional {patches} (internvl2)."""
    logits = lm.forward(params, batch["tokens"], cfg,
                        prefix_embeds=batch.get("patches"), chunk=chunk,
                        remat=remat)
    labels = batch["labels"]
    off = logits.shape[1] - labels.shape[1]
    logits = logits[:, off:].float()
    mask = labels >= 0
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        labels.clamp(min=0).long()[..., None])[..., 0]
    nll = (logz - gold) * mask
    return nll.sum() / mask.sum().clamp(min=1)


def _split_microbatches(batch: dict, n: int) -> list[dict]:
    """The batch cut along its leading axis into n microbatches, in
    sequence order."""
    b = batch["tokens"].shape[0]
    if b % n:
        raise ValueError(f"batch of {b} does not split into {n} "
                         f"microbatches")
    return [{k: a[i * (b // n):(i + 1) * (b // n)] for k, a in batch.items()}
            for i in range(n)]


def _value_and_grad(loss, params, batch):
    """(loss, gradient tree) of ``loss(params, batch)`` with respect to
    every parameter leaf; the inputs are not touched."""
    leaf = [p.detach().requires_grad_(True) for p in leaves(params)]
    value = loss(unflatten(params, leaf), batch)
    grads = torch.autograd.grad(value, leaf)
    return value.detach(), unflatten(params, list(grads))


def make_train_step(cfg: ModelConfig, *, optimizer="adamw",
                    mode: str = "baseline", n_microbatches: int = 1,
                    chunk=0, remat=True, lr=1e-3, wd=0.01):
    """A train step ``step(state, batch) -> (state', loss)``.  mode:
    ``"baseline"`` | ``"pot"``."""
    _adamw_only(optimizer)
    if mode not in ("baseline", "pot"):
        raise ValueError(f"mode must be 'baseline' or 'pot', got {mode!r}")
    loss = partial(loss_fn, cfg=cfg, chunk=chunk, remat=remat)

    def apply(state, grads):
        return adamw_update(state.params, grads, state.opt, lr=lr, wd=wd)

    def baseline_step(state: TrainState, batch):
        value, grads = _value_and_grad(loss, state.params, batch)
        params, opt = apply(state, grads)
        return dataclasses.replace(state, params=params, opt=opt,
                                   step=state.step + 1), value

    def pot_step(state: TrainState, batch):
        if n_microbatches > 1:
            # ordered commits: the microbatch transactions accumulate in
            # sequence order, each a fixed-order float add
            gsum = tree_map(lambda p: torch.zeros(p.shape,
                                                  dtype=torch.float32,
                                                  device=p.device),
                            state.params)
            loss_sum = torch.zeros((), dtype=torch.float32,
                                   device=state.step.device)
            for mb in _split_microbatches(batch, n_microbatches):
                value, g = _value_and_grad(loss, state.params, mb)
                for a, b in zip(leaves(gsum), leaves(g)):
                    a.add_(b.float())
                loss_sum = loss_sum + value
                del g
            grads = tree_map(lambda g: g.div_(n_microbatches), gsum)
            value = loss_sum / n_microbatches
        else:
            value, grads = _value_and_grad(loss, state.params, batch)
        # fast-mode direct commit (one fused-kernel launch per leaf)
        params, opt = apply(state, grads)
        return dataclasses.replace(state, params=params, opt=opt,
                                   gv=state.gv + 1,
                                   step=state.step + 1), value

    return pot_step if mode == "pot" else baseline_step
