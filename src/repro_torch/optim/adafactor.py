"""Adafactor with factored second moments (Shazeer & Stern 2018), after
``repro.optim.adafactor``.

The factored row and column statistics keep the optimizer state at
O(R + C) per matrix instead of O(R·C).

**Stacked layers.**  The reference stacks each pattern slot's layers
into one (G, ...) leaf, and Adafactor sees the stacked leaf: a per-layer
norm scale (G, d) is factored, its column statistic ``vc`` (d,) mixing
the G layers' gradients and its ``denom`` averaging over layers; the RMS
update clip is taken over the whole stacked leaf, except for a leaf of
three or more dimensions, more than one group and above 2e8 elements,
which the reference clips group by group (``lax.map``).  The port keeps
one parameter dict per layer (``models/lm.py``), so this module treats
slot i's layers (``layers[i::n_slots]``) as that stacked leaf: its state
holds the statistics in the reference's stacked shapes, under
``stats["layers"][str(i)]``, and each update stacks the layers' leaves
where the reference's whole-leaf clip needs them and walks the groups
where it does not.

``step`` is a 0-d int32 tensor on the parameters' device; ``beta2 = 1 -
step^-0.8`` is computed from it there, in float32.
"""

from __future__ import annotations

import math
from functools import partial

import torch

from repro_torch.tree import flatten_up_to, leaves, unflatten

_GROUPED_ABOVE = 2e8   # elements of a stacked leaf clipped group by group


def _factored(shape) -> bool:
    return len(shape) >= 2


def _slots(layers: list, n_slots: int) -> list[list]:
    """The layers of each pattern slot, in group order."""
    return [layers[i::n_slots] for i in range(n_slots)]


def _stats(shape, device) -> dict:
    zeros = lambda s: torch.zeros(s, dtype=torch.float32, device=device)
    if _factored(shape):
        return {"vr": zeros(shape[:-1]), "vc": zeros(shape[:-2] + shape[-1:])}
    return {"v": zeros(shape)}


def adafactor_init(params, n_slots: int = 1) -> dict:
    """Zero statistics in the reference's shapes (each slot's layer
    leaves stacked over its ``len(layers) // n_slots`` groups; ``n_slots``
    is the model's ``len(cfg.pattern)``) and step 0."""
    stats = {k: _stats(tuple(p.shape), p.device)
             for k, p in params.items() if k != "layers"}
    if "layers" in params:
        stats["layers"] = {
            str(i): unflatten(slot[0], [
                _stats((len(slot),) + tuple(p.shape), p.device)
                for p in leaves(slot[0])])
            for i, slot in enumerate(_slots(params["layers"], n_slots))}
    first = leaves(params)[0]
    return {"stats": stats,
            "step": torch.zeros((), dtype=torch.int32, device=first.device)}


def _leaf_core(p, g, s, *, beta2, lr, eps, clip_threshold, wd):
    """The reference's ``leaf_core``: one leaf's statistics, clipped
    update and new value."""
    g = g.float()
    g2 = g * g + eps
    if _factored(p.shape):
        vr = beta2 * s["vr"] + (1 - beta2) * g2.mean(dim=-1)
        vc = beta2 * s["vc"] + (1 - beta2) * g2.mean(dim=-2)
        denom = vr.mean(dim=-1, keepdim=True)
        u = g * torch.rsqrt(vr[..., None] / denom[..., None]) \
            * torch.rsqrt(vc[..., None, :])
        new_s = {"vr": vr, "vc": vc}
    else:
        v = beta2 * s["v"] + (1 - beta2) * g2
        u = g * torch.rsqrt(v)
        new_s = {"v": v}
    # update clipping (RMS(u) <= clip_threshold)
    rms = torch.sqrt(torch.mean(u * u) + 1e-30)
    u = u / torch.clamp(rms / clip_threshold, min=1.0)
    pf = p.float()
    p2 = pf - lr * u - lr * wd * pf
    return p2.to(p.dtype), new_s


def _stacked_leaf(ps: list, gs: list, s: dict, core):
    """The reference's ``leaf`` on the stacked leaf whose G groups are
    the layer tensors ``ps``: new layer tensors and stacked statistics."""
    shape = (len(ps),) + tuple(ps[0].shape)
    if len(shape) >= 3 and shape[0] > 1 and math.prod(shape) > _GROUPED_ABOVE:
        # group by group (the reference's lax.map): a clip per layer
        outs = [core(p, g, {k: v[i] for k, v in s.items()})
                for i, (p, g) in enumerate(zip(ps, gs))]
        return ([o[0] for o in outs],
                {k: torch.stack([o[1][k] for o in outs]) for k in s})
    p2, s2 = core(torch.stack(ps), torch.stack(gs), s)
    return list(p2.unbind(0)), s2


def _update_layers(layers, grads, stats, core):
    """The per-layer parameter dicts updated slot by slot, each slot's
    layers as the reference's stacked leaves: (new layers, new stats)."""
    n_slots = len(stats)
    new_layers = [None] * len(layers)
    new_stats = {}
    for i, (slot, gslot) in enumerate(zip(_slots(layers, n_slots),
                                          _slots(grads, n_slots))):
        cols_p = [leaves(layer) for layer in slot]
        cols_g = [leaves(layer) for layer in gslot]
        outs = [_stacked_leaf([c[j] for c in cols_p], [c[j] for c in cols_g],
                              s, core)
                for j, s in enumerate(flatten_up_to(slot[0],
                                                    stats[str(i)]))]
        for g in range(len(slot)):
            new_layers[g * n_slots + i] = unflatten(
                slot[0], [o[0][g] for o in outs])
        new_stats[str(i)] = unflatten(slot[0], [o[1] for o in outs])
    return new_layers, new_stats


def adafactor_update(params, grads, state, *, lr=1e-2, eps=1e-30,
                     decay_pow=0.8, clip_threshold=1.0, wd=0.0):
    """One Adafactor step: returns ``(params', state')``, new trees; the
    inputs are left as they were."""
    step = state["step"] + 1
    beta2 = 1.0 - torch.pow(step.float(), -decay_pow)
    core = partial(_leaf_core, beta2=beta2, lr=lr, eps=eps,
                   clip_threshold=clip_threshold, wd=wd)
    stats = state["stats"]
    new_p, new_s = {}, {}
    for k, p in params.items():
        # the top-level leaves are matrices or vectors: the reference's
        # group-by-group branch needs three dimensions
        if k != "layers":
            new_p[k], new_s[k] = core(p, grads[k], stats[k])
    if "layers" in params:
        new_p["layers"], new_s["layers"] = _update_layers(
            params["layers"], grads["layers"], stats["layers"], core)
    # the input trees' key order
    new_p = {k: new_p[k] for k in params}
    new_s = {k: new_s[k] for k in stats}
    return new_p, {"stats": new_s, "step": step}
