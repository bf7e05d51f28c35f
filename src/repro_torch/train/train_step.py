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

``make_pot_dp_step`` is the fully deterministic data-parallel step (the
end-to-end configuration of ``launch/train_lm.py``): every rank of a
``torch.distributed`` group takes its slice of the global batch, and the
gradients cross ranks by the fixed-ring ordered reduction
(``optim/ordered_reduce.py``), so the trained weights are bitwise the
same whatever the arrival timing.

Parameters are float32 master weights; the model casts them to bf16 at
use.  A step returns ``(new_state, loss)`` and leaves the state it was
given as it was.  The optimizer is AdamW or Adafactor.
``make_train_step`` takes the reference's profile (``prof``, ``SMOKE``
by default) and hands it to the model.  On a mesh, ``pure_dp`` too,
every rank holds its own shards of the state (``lm.local_params``:
every leaf cut by its spec, the embedding and head by vocab block;
:func:`opt_specs` gives the state's spec tree), runs the model SPMD on
its block of the batch and sequence (``models/lm.py``) and computes the
same loss from the logits gathered whole; the backward pass's ordered
sums over ranks leave every whole leaf's gradient whole and equal on
every rank and a shard's that of the shard, and each rank commits its
own leaves: AdamW one fused kernel a leaf on the card, Adafactor with
the whole leaf's statistics, its means summed over the ranks that
share the leaf (``optim/adafactor.py``).  The reference's
``grad_specs`` pins have nothing to pin: each rank's gradients already
have its leaves' shapes.
``make_train_step`` and ``make_pot_dp_step`` train all
ten architectures: every layer kind (``"attn"``, ``"local"``,
``"mamba"``, ``"rglru"``), dense and MoE MLPs, internvl2's ``patches``
and whisper's ``frames`` (through ``lm.encode``).  A MoE layer takes
its capacity from the tokens of each call, as the reference's does, so
the microbatch split and a DP rank's slice move its drops.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import torch

from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.optim import (adafactor_init, adafactor_update, adamw_init,
                               adamw_update, ordered_ring_reduce)
from repro_torch.optim.ordered_reduce import ring_position
from repro_torch.runtime.shardings import SMOKE, P, Profile, norm_spec
from repro_torch.runtime.spans import span
from repro_torch.tree import leaves, tree_map, unflatten


@dataclasses.dataclass
class TrainState:
    params: dict
    opt: dict
    gv: torch.Tensor     # () int32: global version (last committed txn)
    step: torch.Tensor   # () int32


def _unknown(optimizer) -> ValueError:
    return ValueError(f"optimizer must be 'adamw' or 'adafactor', got "
                      f"{optimizer!r}")


def _optimizer(optimizer: str, lr, wd, cfg: ModelConfig,
               prof: Profile = SMOKE):
    """The update function and its hyperparameters: Adafactor takes the
    learning rate only, as in the reference, and the parameters' spec
    tree with ``prof``'s mesh (none off a mesh: nothing is cut)."""
    if optimizer == "adamw":
        return partial(adamw_update, lr=lr, wd=wd)
    if optimizer == "adafactor":
        return partial(adafactor_update, lr=lr,
                       specs=lm.param_specs(cfg, prof),
                       mesh=prof.mesh if lm.on_mesh(prof) else None)
    raise _unknown(optimizer)


def init_state(params, optimizer="adamw", *,
               cfg: ModelConfig | None = None) -> TrainState:
    """A fresh state: step 0, gv 0 and zero optimizer state.  Adafactor
    keeps its statistics in the reference's tree and stacked shapes,
    laid out by ``cfg``'s pattern slots and tail (one slot and no tail
    without a ``cfg``: a tree of plain leaves)."""
    if optimizer == "adamw":
        opt = adamw_init(params)
    elif optimizer == "adafactor":
        layout = () if cfg is None else (len(cfg.pattern),
                                         len(cfg.tail_pattern))
        opt = adafactor_init(params, *layout)
    else:
        raise _unknown(optimizer)
    zero = lambda: torch.zeros((), dtype=torch.int32,
                               device=opt["step"].device)
    return TrainState(params=params, opt=opt, gv=zero(), step=zero())


def _zip_map(fn, spec, like):
    """``fn(spec_leaf, like_subtree)`` over a spec tree, keeping its
    structure; ``like`` holds the spec tree's structure (dicts by key)."""
    if isinstance(spec, P):
        return fn(spec, like)
    if isinstance(spec, dict):
        return {k: _zip_map(fn, s, like[k]) for k, s in spec.items()}
    return [_zip_map(fn, s, x) for s, x in zip(spec, like, strict=True)]


def _lead(spec_tree):
    """Every spec of the tree with a leading ``None``: the stacked group
    axis of a pattern slot."""
    return _zip_map(lambda s, _: P(None, *s), spec_tree, spec_tree)


def opt_specs(pspecs, params, optimizer: str, cfg: ModelConfig) -> dict:
    """The spec tree of the optimizer state (:func:`init_state`) of
    ``params`` laid out by ``pspecs`` (``lm.param_specs``).  AdamW: the
    moments by the parameters' specs.  Adafactor: the statistics in
    their stacked layout (``optim/adafactor.py``), each pattern slot's
    specs with the group axis in front, a factored leaf's ``vr`` and
    ``vc`` its spec without the last and without the second last dim,
    as the reference's."""
    if optimizer == "adamw":
        return {"m": pspecs, "v": pspecs, "step": P()}

    def leaf(spec, ndim):
        t = norm_spec(spec, ndim)
        if ndim >= 2:
            return {"vr": P(*t[:-1]), "vc": P(*(t[:-2] + t[-1:]))}
        return {"v": spec}

    def plain(spec_tree, like, stacked):
        return _zip_map(lambda s, p: leaf(s, p.ndim + stacked), spec_tree,
                        like)

    stats = {}
    for k, s in pspecs.items():
        if k == "layers":
            slots = len(cfg.pattern)
            n_grouped = len(s) - len(cfg.tail_pattern)
            stats[k] = {str(i): plain(_lead(s[i]), params[k][i], 1)
                        for i in range(slots)}
            if cfg.tail_pattern:
                stats["tail"] = {str(j): plain(s[n_grouped + j],
                                               params[k][n_grouped + j], 0)
                                 for j in range(len(cfg.tail_pattern))}
        elif k == "enc_layers":
            stats[k] = plain(_lead(s[0]), params[k][0], 1)
        else:
            stats[k] = leaf(s, params[k].ndim)
    return {"stats": stats, "step": P()}


def loss_fn(params, batch, cfg: ModelConfig, *, prof: Profile = SMOKE,
            chunk=0, remat=True):
    """Next-token cross-entropy, averaged over the labels >= 0.  batch:
    {tokens (B, S), labels (B, S)} plus optional {frames} (whisper, the
    encoder's input) and {patches} (internvl2); ``prof`` goes to
    ``lm.forward``."""
    enc = None
    if cfg.encoder_layers:
        enc = lm.encode(params, batch["frames"], cfg, prof, remat=remat)
    logits = lm.forward(params, batch["tokens"], cfg, prof,
                        prefix_embeds=batch.get("patches"), enc=enc,
                        chunk=chunk, remat=remat)
    labels = batch["labels"]
    off = logits.shape[1] - labels.shape[1]
    with span("pot.loss"):
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


def _accumulate(loss, params, batch, n_microbatches: int):
    """(loss, gradients) of the batch.  Over several microbatches the
    transactions accumulate in float32 in sequence order, each a
    fixed-order float add, then divide by their number (the span
    ``pot.grad_sum`` around the sums, not the microbatches' passes)."""
    if n_microbatches == 1:
        return _value_and_grad(loss, params, batch)
    with span("pot.grad_sum"):
        gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), params)
        loss_sum = torch.zeros((), dtype=torch.float32,
                               device=leaves(params)[0].device)
    for mb in _split_microbatches(batch, n_microbatches):
        value, g = _value_and_grad(loss, params, mb)
        with span("pot.grad_sum"):
            for a, b in zip(leaves(gsum), leaves(g)):
                a.add_(b.float())
            loss_sum = loss_sum + value
        del g
    with span("pot.grad_sum"):
        return (loss_sum / n_microbatches,
                tree_map(lambda g: g.div_(n_microbatches), gsum))


def make_train_step(cfg: ModelConfig, *, prof: Profile = SMOKE,
                    optimizer="adamw", mode: str = "baseline",
                    n_microbatches: int = 1, chunk=0, remat=True, lr=1e-3,
                    wd=0.01):
    """A train step ``step(state, batch) -> (state', loss)``.  mode:
    ``"baseline"`` | ``"pot"``.  With a mesh in ``prof`` the state is a
    rank's (module docstring) and ``batch`` the whole batch on every
    rank."""
    upd = _optimizer(optimizer, lr, wd, cfg, prof)
    if mode not in ("baseline", "pot"):
        raise ValueError(f"mode must be 'baseline' or 'pot', got {mode!r}")
    loss = partial(loss_fn, cfg=cfg, prof=prof, chunk=chunk, remat=remat)

    def baseline_step(state: TrainState, batch):
        value, grads = _value_and_grad(loss, state.params, batch)
        with span("pot.commit"):
            params, opt = upd(state.params, grads, state.opt)
        return dataclasses.replace(state, params=params, opt=opt,
                                   step=state.step + 1), value

    def pot_step(state: TrainState, batch):
        # ordered commits of the microbatch transactions
        value, grads = _accumulate(loss, state.params, batch,
                                   n_microbatches)
        # fast-mode direct commit (one fused-kernel launch per leaf)
        with span("pot.commit"):
            params, opt = upd(state.params, grads, state.opt)
        return dataclasses.replace(state, params=params, opt=opt,
                                   gv=state.gv + 1,
                                   step=state.step + 1), value

    return pot_step if mode == "pot" else baseline_step


def make_pot_dp_step(cfg: ModelConfig, group=None, *, optimizer="adamw",
                     n_microbatches: int = 1, lr=1e-3, wd=0.01,
                     remat=False):
    """The fully deterministic pure data-parallel Pot step over the ranks
    of ``group`` (the default process group when None; no process group
    at all is one rank).

    Every rank calls ``step(state, batch)`` with the same state and the
    same global batch and takes rank i's contiguous slice of its rows
    (the reference's ``shard_map`` over the data axis).  Its gradient is
    a preordered transaction (the sequencer's order is the ring
    position): microbatches accumulate in float32 in sequence order, the
    gradients and the loss cross ranks by the fixed-ring ordered
    reduction, divided by the rank count, and every rank applies the
    same fast-mode commit, with ``gv`` and ``step`` + 1.  The weights are
    replicated."""
    upd = _optimizer(optimizer, lr, wd, cfg)
    n_shards, rank = ring_position(group)
    loss = partial(loss_fn, cfg=cfg, remat=remat)

    def step(state: TrainState, batch):
        b = batch["tokens"].shape[0]
        if b % n_shards:
            raise ValueError(f"global batch of {b} does not split over "
                             f"{n_shards} ranks")
        part = b // n_shards
        local = {k: a[rank * part:(rank + 1) * part]
                 for k, a in batch.items()}
        value, grads = _accumulate(loss, state.params, local,
                                   n_microbatches)
        # ordered commit across ranks: the fixed-ring deterministic sum
        # (the reduction's own output, or at one rank the gradient buffer
        # itself, divided in place)
        grads = tree_map(
            lambda g: ordered_ring_reduce(g, group).div_(n_shards), grads)
        value = ordered_ring_reduce(value[None], group)[0] / n_shards
        with span("pot.commit"):
            params, opt = upd(state.params, grads, state.opt)
        return dataclasses.replace(state, params=params, opt=opt,
                                   gv=state.gv + 1,
                                   step=state.step + 1), value

    return step
