"""Mixture-of-Experts block, after ``repro.models.moe``'s dense path
(arctic-480b: 128 experts top-2 and a dense residual FFN;
deepseek-moe-16b: 64 experts top-6 and 2 shared experts).

Routing and dispatch follow the reference bit for bit:

- top-k over the router's softmax, ties to the lower expert index (as
  ``lax.top_k``; a stable descending sort here, since ``torch.topk``
  promises no order among ties);
- capacity ``max(1, int(T * k / E * capacity_factor))`` per expert,
  with T the tokens of the call (so a decode step of 8 slots gives
  deepseek-moe-16b a capacity of 1);
- an assignment's slot is its rank among the earlier (token, k)
  assignments to its expert; those past the capacity are dropped.

The reference scatters the kept rows with ``mode="drop"``; here each
expert's slots gather their rows through a stable sort of the
assignments by expert, which gives the same bits with no scatter.  The
reference's ``shard_map`` path (expert parallelism over a mesh) waits
for ROADMAP queue 1 item 9's ``mesh=``; on one card the dense path is
the path.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.blocks import C, _cast, _normal, init_mlp, mlp_apply
from repro_torch.models.config import ModelConfig


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


def moe_apply(p, x, cfg: ModelConfig):
    """x (B, S, D) -> (B, S, D), in x's dtype (weights cast to it)."""
    p = _cast(p, x.dtype)
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    t = b * s
    xt = x.reshape(t, d)
    gate, eidx = route(xt, p["router"], k)
    cap = capacity(t, k, e, cfg.capacity_factor)
    flat_e = eidx.reshape(-1)
    pos, keep = dispatch_positions(flat_e, e, cap)
    y_e = expert_ffn(dispatch(xt, flat_e, k, e, cap), p["w1"], p["w3"],
                     p["w2"])
    out = combine(y_e, flat_e, pos, keep, gate, t, k).reshape(b, s, d)
    if "shared" in p:
        out = out + mlp_apply(p["shared"], x, cfg)
    if "residual" in p:
        out = out + mlp_apply(p["residual"], x, cfg)
    return out
