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

The reference scatters the kept rows with ``mode="drop"``; here each
expert's slots gather their rows through a stable sort of the
assignments by expert, which gives the same bits with no scatter.

Two dispatch paths, chosen as the reference chooses them:

- **dense** (the profile disabled or without a mesh): every token of the
  call routed together in one process.
- **expert parallelism** (``prof.enabled`` and ``prof.mesh`` set, at any
  number of ranks, one included): the reference's ``_moe_shardmap``
  GShard schedule over a ``DeviceMesh`` whose dims are the profile's
  data axes and its model axis.  ``x`` enters whole and equal on every
  rank, as every other layer keeps it; each rank takes its block (batch
  over the data axes as ``prof.da`` says, the sequence over the model
  axis where it divides, else whole, as at decode), routes it with the
  capacity of the block's own tokens, sends expert chunk j to model rank
  j (``all_to_all_single``; the received chunks concatenated along the
  capacity axis in source order, as the reference's tiled
  ``all_to_all``), all-gathers its E/n_model experts' weight shards
  over the data axes (ZeRO), runs them, sends the outputs back,
  combines, and gathers the blocks back to the whole (B, S, D) on every
  rank.  Each step is a ``torch.autograd.Function`` with its adjoint:
  the gather-out takes the rank's block, the block-in gathers the
  blocks' gradients (``dx`` whole and equal on every rank), the exchange
  reverses, and the two sums, the router's over every rank and each
  expert shard's over the data ranks, go through the fixed-ring
  ``ordered_ring_reduce`` over the mesh's subgroups, so that a gradient
  is bitwise the same whatever the ranks' timing.  A gradient needs
  blocks that partition the tokens (the sequence split over the model
  axis and the batch over the data axes); a call whose blocks repeat
  tokens (a decode step's) runs forward only.  A rank holds its
  experts' shards (:func:`local_moe`), every other weight whole.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.models.blocks import (C, _cast, _normal, init_mlp,
                                       mlp_apply, mlp_specs)
from repro_torch.models.config import ModelConfig
from repro_torch.optim.ordered_reduce import ordered_ring_reduce
from repro_torch.runtime.shardings import (SMOKE, P, Profile, axis_names,
                                           local_shard)


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


def dispatch_positions(flat_e, e: int, cap: int):
    """flat_e (T*k,) expert of each assignment in (token, k) order ->
    (pos, keep): the assignment's rank among the earlier ones to its
    expert, and whether it is under the capacity."""
    oh = F.one_hot(flat_e, e)
    pos = ((torch.cumsum(oh, dim=0) - 1) * oh).sum(-1)
    return pos, pos < cap


def dispatch(xt, flat_e, k: int, e: int, cap: int):
    """x_e (E, cap, D): slot c of expert e holds the token of the c-th
    assignment to e in (token, k) order, zeros past the assignments.
    A gather through a stable sort by expert, no scatter."""
    tk = flat_e.shape[0]
    order = torch.argsort(flat_e, stable=True)
    counts = F.one_hot(flat_e, e).sum(0)                    # (E,)
    start = torch.cumsum(counts, dim=0) - counts
    c = torch.arange(cap, device=xt.device)
    slot = (start[:, None] + c[None]).clamp(max=tk - 1)     # (E, cap)
    filled = c[None] < counts[:, None]
    rows = xt[order[slot] // k]                             # (E, cap, D)
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
    gate, eidx = route(xt, router, k)
    cap = capacity(t, k, e, cfg.capacity_factor)
    flat_e = eidx.reshape(-1)
    pos, keep = dispatch_positions(flat_e, e, cap)
    x_e = dispatch(xt, flat_e, k, e, cap)
    if ep is not None:
        x_e = _Across.apply(x_e, ep.exchange, ep.exchange_back)
    y_e = expert_ffn(x_e, w1, w3, w2)
    if ep is not None:
        y_e = _Across.apply(y_e, ep.exchange_back, ep.exchange)
    return combine(y_e, flat_e, pos, keep, gate, t, k)


def moe_apply(p, x, cfg: ModelConfig, prof: Profile = SMOKE):
    """x (B, S, D) -> (B, S, D), in x's dtype (weights cast to it).  On a
    profile with a mesh, the expert-parallel schedule (module
    docstring); ``p`` then holds the rank's expert shards."""
    p = _cast(p, x.dtype)
    b, s, d = x.shape
    if prof.enabled and prof.mesh is not None:
        out = _expert_parallel(p, x, cfg, prof)
    else:
        out = _routed(x.reshape(b * s, d), p["router"], p["w1"], p["w3"],
                      p["w2"], cfg).reshape(b, s, d)
    if "shared" in p:
        out = out + mlp_apply(p["shared"], x, cfg)
    if "residual" in p:
        out = out + mlp_apply(p["residual"], x, cfg)
    return out


# ------------------------------------------------------ expert parallelism
EXPERT_LEAVES = ("w1", "w3", "w2")


def local_moe(p: dict, cfg: ModelConfig, prof: Profile) -> dict:
    """The MoE weights ``p`` as a rank holds them under ``prof``: the
    expert leaves cut to the rank's shard by :func:`moe_specs` (experts
    over the model axis, D of w1/w3 and F of w2 over the data axes),
    every other leaf the same tensor."""
    specs = moe_specs(cfg, prof)
    return dict(p, **{n: local_shard(p[n], specs[n], prof.mesh)
                      for n in EXPERT_LEAVES})


class _Across(torch.autograd.Function):
    """A step of the schedule that crosses ranks: ``fwd(t)`` forward and
    its adjoint ``bwd(grad)`` backward."""

    @staticmethod
    def forward(ctx, t, fwd, bwd):
        ctx.bwd = bwd
        return fwd(t)

    @staticmethod
    def backward(ctx, grad):
        return ctx.bwd(grad.contiguous()), None, None


def _gather(t, group, dim: int):
    """The group's tensors concatenated along ``dim`` in rank order."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim) if len(parts) > 1 else parts[0]


def _block(t, dim: int, index: int, ways: int):
    n = t.shape[dim] // ways
    return t.narrow(dim, index * n, n)


class _ExpertMesh:
    """One rank's place in the schedule for an input of ``shape``: its
    model group and coordinate, the data axes' groups (mesh order, major
    first) with the rank's flat coordinate over them, and the blocks'
    layout.  Refuses what the reference's ``shard_map`` refuses."""

    def __init__(self, cfg: ModelConfig, prof: Profile, shape):
        mesh = prof.mesh
        names = tuple(mesh.mesh_dim_names or ())
        want = tuple(prof.data_axes) + (prof.model_axis,)
        if prof.pure_dp or names != want:
            raise ValueError(f"expert parallelism takes a mesh of dims "
                             f"{want} and a profile without pure_dp; got "
                             f"{names}{' and pure_dp' * prof.pure_dp}")
        coord = mesh.get_coordinate()
        axis = lambda a: (mesh.get_group(a), mesh.size(names.index(a)),
                          coord[names.index(a)])
        self.model, self.n_model, self.m = axis(prof.model_axis)
        if cfg.n_experts % self.n_model:
            raise ValueError(f"{cfg.n_experts} experts do not split over "
                             f"the model axis {prof.model_axis!r} of "
                             f"{self.n_model} ranks")
        self.data = [axis(a) for a in prof.data_axes]
        self.n_data, self.i_data = self._flat(self.data)
        if not prof.fsdp and self.n_data > 1:
            # the reference gathers the expert shards over the data axes,
            # so it takes them cut there; the gradients' sum over the
            # data ranks, which split the tokens, is that gather's adjoint
            raise ValueError(f"expert parallelism over the data axes "
                             f"{tuple(prof.data_axes)} of {self.n_data} "
                             f"ranks takes a profile with fsdp")
        self.batch = [axis(a) for a in axis_names(prof.da)]
        b, s, _ = shape
        self.n_batch, self.i_batch = self._flat(self.batch)
        if b % self.n_batch:
            raise ValueError(f"a batch of {b} does not split over the data "
                             f"axes {axis_names(prof.da)} of {self.n_batch} "
                             f"ranks")
        self.seq_split = s % self.n_model == 0 and s >= self.n_model
        # the blocks partition the tokens: each rank's are its own
        self.partition = self.seq_split and self.n_batch == self.n_data

    @staticmethod
    def _flat(axes) -> tuple[int, int]:
        n, i = 1, 0
        for _, size, c in axes:
            n, i = n * size, i * size + c
        return n, i

    # the block of x (B, S, ...) and its inverse
    def take_block(self, x):
        x = _block(x, 0, self.i_batch, self.n_batch)
        if self.seq_split:
            x = _block(x, 1, self.m, self.n_model)
        return x.contiguous()

    def gather_blocks(self, x):
        if self.seq_split:
            x = _gather(x, self.model, 1)
        for group, _, _ in reversed(self.batch):    # minor axes first
            x = _gather(x, group, 0)
        return x

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

    # ZeRO: an expert shard gathered over the data axes and its adjoint
    def gather_weight(self, w):
        for group, _, _ in reversed(self.data):
            w = _gather(w, group, 1)
        return w

    def reduce_weight_grad(self, g):
        for group, _, _ in self.data:
            g = ordered_ring_reduce(g, group)
        return _block(g, 1, self.i_data, self.n_data).contiguous()

    # a replicated input (the router) and its gradient's sum over ranks
    @staticmethod
    def replicated(t):
        return t.view_as(t)

    def reduce_replicated_grad(self, g):
        for group in [self.model] + [group for group, _, _ in self.data]:
            g = ordered_ring_reduce(g, group)
        return g


def _expert_parallel(p, x, cfg: ModelConfig, prof: Profile):
    """The routed experts of x (B, S, D) by the expert-parallel schedule
    (module docstring): (B, S, D), whole on every rank."""
    ep = _ExpertMesh(cfg, prof, x.shape)
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
            t.requires_grad for t in (x, p["router"], p["w1"])):
        raise ValueError("the ranks' blocks repeat tokens (the sequence "
                         "not split over the model axis, or the batch not "
                         "over the data axes): such a call carries no "
                         "gradient")
    xl = _Across.apply(x, ep.take_block, ep.gather_blocks)
    bl, sl, _ = xl.shape
    router = _Across.apply(p["router"], ep.replicated,
                           ep.reduce_replicated_grad)
    w1, w3, w2 = (_Across.apply(p[n], ep.gather_weight,
                                ep.reduce_weight_grad)
                  for n in EXPERT_LEAVES)
    y = _routed(xl.reshape(bl * sl, d), router, w1, w3, w2, cfg, ep)
    return _Across.apply(y.reshape(bl, sl, d), ep.gather_blocks,
                         ep.take_block)
