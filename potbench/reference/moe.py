"""The plain reference of a fine-grained MoE decoder (deepseek-moe-16b's
family): the model of ``common.py`` whose feed-forward sublayer is a
mixture of experts, with the routing rule the port documents.

- Router: probabilities softmax(x Wr) over the E experts; each token
  takes its ``top_k`` most probable experts, ties to the lower index,
  and their probabilities divided by their sum as gates.
- Capacity: ``max(1, int(T k / E capacity_factor))`` assignments per
  expert, T the tokens routed together: a microbatch's.  Assignments are
  ranked per expert in (token, k) order; those ranked at or past the
  capacity are dropped.
- Expert e: SwiGLU with W1[e], W3[e], W2[e]; the output is the gated sum
  of a token's kept assignments, plus the shared experts, one SwiGLU of
  ``n_shared_experts`` x ``d_ff`` columns, on every token.

A microbatch is routed whole (its capacity depends on all its tokens),
so each layer is recomputed in the backward pass to fit."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from potbench.reference.common import Precision, forward_loss, swiglu


def moe(p: dict, x, cfg: dict, prec: Precision):
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    t, e, k = b * s, cfg["n_experts"], cfg["top_k"]
    probs = torch.softmax(prec.mm(xt, p["router"]), -1)
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate = top[:, :k] / top[:, :k].sum(-1, keepdim=True).clamp(min=1e-9)
    cap = max(1, int(t * k / e * cfg["capacity_factor"]))
    flat = idx[:, :k].reshape(-1)                       # (token, k) order
    order = torch.argsort(flat, stable=True)            # by expert
    counts = (flat[:, None] == torch.arange(e, device=x.device)).sum(0)
    start = torch.cumsum(counts, 0) - counts
    rank = torch.arange(t * k, device=x.device) - start[flat[order]]
    kept = order[rank < cap]                            # by expert
    rows = xt[kept // k]
    outs, o = [], 0
    for j, n in enumerate(torch.clamp(counts, max=cap).tolist()):
        seg = rows[o:o + n]
        outs.append(prec.mm(F.silu(prec.mm(seg, p["w1"][j]))
                            * prec.mm(seg, p["w3"][j]), p["w2"][j]))
        o += n
    y = torch.cat(outs + [xt.new_zeros(1, d)])          # a zero row last
    slot = torch.full((t * k,), kept.numel(), dtype=torch.long,
                      device=x.device)
    slot[kept] = torch.arange(kept.numel(), device=x.device)
    routed = (y[slot].view(t, k, d) * gate[..., None]).sum(1)
    out = routed + swiglu(p["shared"], xt, prec) if "shared" in p else routed
    return out.view(b, s, d)


def ffn(lp: dict, h, cfg: dict, prec: Precision):
    return moe(lp["moe"], h, cfg, prec)


def accumulate(params, tokens, labels, cfg: dict, prec: Precision,
               weight: float):
    loss = forward_loss(params, tokens, labels, cfg, prec,
                        lambda lp, h: ffn(lp, h, cfg, prec), remat=True)
    (loss * weight).backward()
    return loss.detach()
