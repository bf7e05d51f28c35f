"""Mixture-of-Experts block, after ``repro.models.moe``
(arctic-480b: 128 experts top-2 and a dense residual FFN;
deepseek-moe-16b: 64 experts top-6 and 2 shared experts).

Routing and dispatch follow the reference bit for bit:

- top-k over the router's softmax, ties to the lower expert index (as
  ``lax.top_k``; a stable descending sort here, since ``torch.topk``
  promises no order among ties);
- capacity ``max(1, int(T * k / E * capacity_factor))`` per expert,
  with T the tokens routed together (so a decode step of 8 slots gives
  deepseek-moe-16b a capacity of 1);
- an assignment's slot is its rank among the earlier (token, k)
  assignments to its expert; those past the capacity are dropped.

The reference ranks the assignments by a cumulative sum over their
one-hot experts and scatters the kept rows with ``mode="drop"``; here
one stable sort of the assignments by expert gives both, with the same
bits: an assignment's rank is its place in its expert's run of the
sort, and each expert's slots gather their rows through the sort, with
no (T*k, E) one-hot and no scatter (neither fast on the card in
deterministic mode).

Two dispatch paths, chosen as the reference chooses them:

- **dense** (the profile disabled or without a mesh): every token of the
  call routed together in one process.
- **expert parallelism** (``prof.enabled`` and ``prof.mesh`` set, at any
  number of ranks, one included): the reference's ``_moe_shardmap``
  GShard schedule over a ``DeviceMesh`` whose dims are the profile's
  data axes and its model axis.  Each rank works on its block of the
  tokens (batch over the data axes as ``prof.da`` says, the sequence
  over the model axis where it divides, else whole, as at decode): the
  block the model's residual stream already holds (``lm`` passes its
  ``shardings.Place``), or one it takes from an ``x`` whole and equal on
  every rank, whose output it then gathers back to the whole (B, S, D)
  on every rank.  It routes the block with the capacity of the block's
  own tokens, sends expert chunk j to model rank j
  (``all_to_all_single``; the received chunks concatenated along the
  capacity axis in source order, as the reference's tiled
  ``all_to_all``), all-gathers its E/n_model experts' weight shards
  over the data axes (ZeRO), runs them, sends the outputs back,
  combines, and adds the shared experts and the dense residual on the
  block, tensor-parallel as the dense MLP is (``blocks.mlp_apply``).
  Each step is a ``torch.autograd.Function`` with its adjoint: the
  gather-out takes the rank's block, the block-in gathers the
  blocks' gradients (``dx`` whole and equal on every rank), the exchange
  reverses, and the sums, the router's over every rank, each expert
  shard's over the data ranks and the shared experts' and dense
  residual's as the MLP's, go through the fixed-ring
  ``ordered_ring_reduce`` over the mesh's subgroups, so that a gradient
  is bitwise the same whatever the ranks' timing.  A gradient needs
  blocks that partition the tokens (the sequence split over the model
  axis and the batch over the data axes); a call whose blocks repeat
  tokens (a decode step's) runs forward only.  A rank holds each leaf
  as :func:`moe_specs` cuts it (``lm.local_params``): its experts'
  shards, the shared experts' and dense residual's MLP shards, the
  router whole.  A ``pure_dp`` profile is refused: its expert specs
  name the model axis twice, and the reference's ``shard_map`` fails on
  them.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.models.blocks import (C, _cast, _normal, init_mlp,
                                       mlp_apply, mlp_specs)
from repro_torch.models.config import ModelConfig
from repro_torch.runtime.shardings import (ALONE, SMOKE, Across, P, Place,
                                           Profile)
from repro_torch.runtime.spans import span


def init_moe(gen: torch.Generator, cfg: ModelConfig, dtype=C) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    std = d ** -0.5
    p = {"router": _normal(gen, (d, e), std, dtype),
         "w1": _normal(gen, (e, d, f), std, dtype),
         "w3": _normal(gen, (e, d, f), std, dtype),
         "w2": _normal(gen, (e, f, d), std, dtype)}
    if cfg.n_shared_experts:
        p["shared"] = init_mlp(gen, cfg, d_ff=cfg.n_shared_experts * f,
                               dtype=dtype)
    if cfg.dense_residual:
        p["residual"] = init_mlp(gen, cfg, d_ff=cfg.residual_d_ff,
                                 dtype=dtype)
    return p


def moe_specs(cfg: ModelConfig, prof: Profile) -> dict:
    """The spec tree of :func:`init_moe`'s weights."""
    p = {"router": P(None, None),
         "w1": prof.experts_in(), "w3": prof.experts_in(),
         "w2": prof.experts_out()}
    if cfg.n_shared_experts:
        p["shared"] = mlp_specs(cfg, prof)
    if cfg.dense_residual:
        p["residual"] = mlp_specs(cfg, prof)
    return p


def capacity(t: int, k: int, e: int, cf: float) -> int:
    return max(1, int(t * k / e * cf))


def route(xt, router, k: int):
    """xt (T, D) -> (gate (T, k) float32, eidx (T, k)): the top-k
    experts of each token's router softmax, ties to the lower index, and
    their renormalised probabilities."""
    probs = torch.softmax((xt @ router.to(xt.dtype)).float(), dim=-1)
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, eidx = top[:, :k], idx[:, :k]
    return gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9), eidx


def sort_by_expert(flat_e, e: int):
    """flat_e (T*k,) -> (sorted_e, order, start): the assignments' stable
    sort by expert (their experts in that order, and the order) and where
    each expert's run of it begins, (E + 1,) with ``start[E] = T*k``."""
    sorted_e, order = torch.sort(flat_e, stable=True)
    start = torch.searchsorted(sorted_e, torch.arange(
        e + 1, device=flat_e.device, dtype=flat_e.dtype))
    return sorted_e, order, start


def dispatch_positions(flat_e, e: int, cap: int, by_e=None):
    """flat_e (T*k,) expert of each assignment in (token, k) order ->
    (pos, keep): the assignment's rank among the earlier ones to its
    expert, and whether it is under the capacity.  ``by_e`` is
    :func:`sort_by_expert` of flat_e where the caller has it."""
    sorted_e, order, start = by_e or sort_by_expert(flat_e, e)
    # the sort is stable, so place j of an expert's run is its rank
    rank = torch.arange(flat_e.shape[0], device=flat_e.device) \
        - start[sorted_e]
    pos = rank[torch.argsort(order)]        # back to (token, k) order
    return pos, pos < cap


def dispatch(xt, flat_e, k: int, e: int, cap: int, by_e=None):
    """x_e (E, cap, D): slot c of expert e holds the token of the c-th
    assignment to e in (token, k) order, zeros past the assignments.
    A gather through the stable sort by expert (``by_e``, as in
    :func:`dispatch_positions`), no scatter."""
    _, order, start = by_e or sort_by_expert(flat_e, e)
    c = torch.arange(cap, device=xt.device)
    slot = start[:-1, None] + c[None]                       # (E, cap)
    filled = slot < start[1:, None]
    rows = xt[order[slot.clamp(max=flat_e.shape[0] - 1)] // k]
    return rows.masked_fill_(~filled[..., None], 0)


def combine(y_e, flat_e, pos, keep, gate, t: int, k: int):
    """The kept assignments' expert outputs, weighted by their gates and
    summed over k: (T, D)."""
    gath = y_e[flat_e, torch.where(keep, pos, 0)]           # (T*k, D)
    gath = gath * keep.to(y_e.dtype)[:, None]
    gath = gath * gate.reshape(-1)[:, None].to(y_e.dtype)
    return gath.reshape(t, k, -1).sum(dim=1)


def expert_ffn(x_e, w1, w3, w2):
    """SwiGLU of each expert over its slots: (E, cap, D) -> (E, cap, D)."""
    h = F.silu(torch.bmm(x_e, w1)).mul_(torch.bmm(x_e, w3))
    return torch.bmm(h, w2)


def _routed(xt, router, w1, w3, w2, cfg: ModelConfig, ep=None):
    """The routed experts over the tokens xt (T, D), the capacity taken
    from T: (T, D).  ``ep`` (an :class:`_ExpertMesh`) sends the dispatched
    blocks to their experts' ranks and back."""
    e, k = cfg.n_experts, cfg.top_k
    t = xt.shape[0]
    with span("pot.moe.route"):
        gate, eidx = route(xt, router, k)
    cap = capacity(t, k, e, cfg.capacity_factor)
    flat_e = eidx.reshape(-1)
    with span("pot.moe.dispatch"):
        by_e = sort_by_expert(flat_e, e)
        pos, keep = dispatch_positions(flat_e, e, cap, by_e)
        x_e = dispatch(xt, flat_e, k, e, cap, by_e)
    if ep is not None:
        x_e = Across.apply(x_e, ep.exchange, ep.exchange_back)
    with span("pot.moe.experts"):
        y_e = expert_ffn(x_e, w1, w3, w2)
    if ep is not None:
        y_e = Across.apply(y_e, ep.exchange_back, ep.exchange)
    with span("pot.moe.combine"):
        return combine(y_e, flat_e, pos, keep, gate, t, k)


def moe_apply(p, x, cfg: ModelConfig, prof: Profile = SMOKE,
              place: Place | None = None):
    """x (B, S, D) -> (B, S, D), in x's dtype (weights cast to it).  On a
    profile with a mesh, the expert-parallel schedule (module
    docstring); ``p`` then holds the rank's expert shards, and x is whole
    on every rank or, with the ``place`` of a model's call
    (``shardings.Place``), the rank's block of it, and so is the
    output."""
    with span("pot.moe"):
        return _moe(_cast(p, x.dtype), x, cfg, prof, place)


def _moe(p, x, cfg: ModelConfig, prof: Profile, place: Place | None):
    """:func:`moe_apply` with ``p`` cast to x's dtype."""
    if prof.enabled and prof.mesh is not None:
        if place is None or place is ALONE:     # x whole on every rank
            ep = _ExpertMesh(cfg, prof, x.shape)
            xl = Across.apply(x, ep.take_block, ep.gather_blocks)
            return Across.apply(_expert_parallel(p, xl, cfg, ep),
                                ep.gather_blocks, ep.take_block)
        ep = _ExpertMesh(cfg, prof, place.shape)
        if ep.seq_split != place.seq_split:     # other blocks
            return place.whole_out(_moe(p, place.whole_in(x), cfg, prof,
                                        None))
        return _expert_parallel(p, x, cfg, ep)
    b, s, d = x.shape
    out = _routed(x.reshape(b * s, d), p["router"], p["w1"], p["w3"],
                  p["w2"], cfg).reshape(b, s, d)
    return _dense_parts(p, x, out, cfg)


def _dense_parts(p, x, out, cfg: ModelConfig, place: Place = ALONE):
    """``out`` plus the shared experts' and the dense residual's outputs
    on x, where the layer has them (on the rank's ``place``)."""
    for name in ("shared", "residual"):
        if name in p:
            out = out + mlp_apply(p[name], x, cfg, place)
    return out


# ------------------------------------------------------ expert parallelism
EXPERT_LEAVES = ("w1", "w3", "w2")


class _ExpertMesh(Place):
    """One rank's place in the schedule for an input of ``shape``
    (``shardings.Place``, the sequence split over the model axis where
    it divides it, whatever ``seq_shard``).  Refuses what the
    reference's ``shard_map`` refuses."""

    def __init__(self, cfg: ModelConfig, prof: Profile, shape):
        if prof.pure_dp:
            # the reference's shard_map fails on these specs too
            raise ValueError(f"under pure_dp the expert specs "
                             f"{prof.experts_in()} name the model axis "
                             f"{prof.model_axis!r} twice")
        super().__init__(prof, shape, seq_shard=True)
        if cfg.n_experts % self.n_model:
            raise ValueError(f"{cfg.n_experts} experts do not split over "
                             f"the model axis {prof.model_axis!r} of "
                             f"{self.n_model} ranks")
        if not prof.fsdp and self.n_data > 1:
            # the reference gathers the expert shards over the data axes,
            # so it takes them cut there; the gradients' sum over the
            # data ranks, which split the tokens, is that gather's adjoint
            raise ValueError(f"expert parallelism over the data axes "
                             f"{tuple(prof.data_axes)} of {self.n_data} "
                             f"ranks takes a profile with fsdp")
        # the blocks partition the tokens: each rank's are its own
        self.partition = self.seq_split and self.n_batch == self.n_data

    # the exchange of expert blocks over the model axis and its inverse
    def exchange(self, x_e):
        """(E, cap, D) -> (E/n_model, n_model * cap, D): chunk j of the
        experts to model rank j, the received chunks along the capacity
        axis in source order."""
        e, cap, d = x_e.shape
        n = self.n_model
        x_e = x_e.contiguous()
        out = torch.empty_like(x_e)
        dist.all_to_all_single(out, x_e, group=self.model)
        return out.view(n, e // n, cap, d).transpose(0, 1).reshape(
            e // n, n * cap, d)

    def exchange_back(self, y_e):
        """(E/n_model, n_model * cap, D) -> (E, cap, D)."""
        el, ncap, d = y_e.shape
        n = self.n_model
        send = y_e.reshape(el, n, ncap // n, d).transpose(0, 1).contiguous()
        out = torch.empty_like(send)
        dist.all_to_all_single(out, send, group=self.model)
        return out.view(n * el, ncap // n, d)


def _expert_parallel(p, xl, cfg: ModelConfig, ep: _ExpertMesh):
    """The layer on the rank's block xl (B_b, S_b, D) by the
    expert-parallel schedule (module docstring): the rank's block of the
    output.  The router is whole on every rank, its gradient summed over
    every rank; the shared experts and the dense residual run
    tensor-parallel on the block."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    el = e // ep.n_model
    for name, shape in (("w1", (el, d // ep.n_data, f)),
                        ("w3", (el, d // ep.n_data, f)),
                        ("w2", (el, f // ep.n_data, d))):
        if tuple(p[name].shape) != shape:
            raise ValueError(f"{name} of shape {tuple(p[name].shape)} where "
                             f"the rank's shard is {shape}: carry the "
                             f"weights across with lm.local_params")
    if not ep.partition and torch.is_grad_enabled() and any(
            t.requires_grad for t in (xl, p["router"], p["w1"])):
        raise ValueError("the ranks' blocks repeat tokens (the sequence "
                         "not split over the model axis, or the batch not "
                         "over the data axes): such a call carries no "
                         "gradient")
    bl, sl, _ = xl.shape
    # ZeRO: each expert shard gathered over the data axes at use
    w1, w3, w2 = (ep.zero(p[n], 1) for n in EXPERT_LEAVES)
    y = _routed(xl.reshape(bl * sl, d), ep.shared(p["router"], model=True),
                w1, w3, w2, cfg, ep).reshape(bl, sl, d)
    return _dense_parts(p, xl, y, cfg, ep)
