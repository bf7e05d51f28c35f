"""Adafactor with factored second moments (Shazeer & Stern 2018), after
``repro.optim.adafactor``.

The factored row and column statistics keep the optimizer state at
O(R + C) per matrix instead of O(R·C).

**Stacked layers.**  The reference stacks each pattern slot's layers
into one (G, ...) leaf, and Adafactor sees the stacked leaf: a per-layer
norm scale (G, d) is factored, its column statistic ``vc`` (d,) mixing
the G layers' gradients and its ``denom`` averaging over layers; the RMS
update clip is taken over the whole leaf, except for a leaf of three or
more dimensions, more than one entry along its first axis and above 2e8
elements, which the reference clips entry by entry along that axis
(``lax.map``).  That rule holds for every leaf of its tree.  The port
keeps one parameter dict per layer (``models/lm.py``), so this module
rebuilds the reference's tree:

- slot i's grouped layers (``layers[i:n_grouped:n_slots]``, where the
  first ``n_grouped = len(layers) - n_tail`` layers are the groups') are
  one stacked leaf set, with statistics under
  ``stats["layers"][str(i)]``;
- each of the ``n_tail`` tail layers after them is its own unstacked
  leaf set, under ``stats["tail"][str(i)]``;
- an encoder's ``enc_layers`` are one stacked slot of G_enc groups,
  under ``stats["enc_layers"]``.

Each update stacks the layers' leaves where the reference's whole-leaf
clip needs them and walks the groups where it does not.

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


def _grouped(shape) -> bool:
    """The reference's choice of the clip entry by entry along axis 0."""
    return (len(shape) >= 3 and shape[0] > 1
            and math.prod(shape) > _GROUPED_ABOVE)


def _layout(layers: list, n_slots: int, n_tail: int):
    """(slot i's grouped layers in group order, for each slot; the tail
    layers)."""
    n_grouped = len(layers) - n_tail
    if n_tail < 0 or n_grouped < 0 or n_grouped % n_slots:
        raise ValueError(f"{len(layers)} layers do not split into "
                         f"{n_slots} slots and a tail of {n_tail}")
    return ([layers[i:n_grouped:n_slots] for i in range(n_slots)],
            layers[n_grouped:])


def _stats(shape, device) -> dict:
    zeros = lambda s: torch.zeros(s, dtype=torch.float32, device=device)
    if _factored(shape):
        return {"vr": zeros(shape[:-1]), "vc": zeros(shape[:-2] + shape[-1:])}
    return {"v": zeros(shape)}


def _stacked_stats(slot: list) -> dict:
    return unflatten(slot[0], [
        _stats((len(slot),) + tuple(p.shape), p.device)
        for p in leaves(slot[0])])


def adafactor_init(params, n_slots: int = 1, n_tail: int = 0) -> dict:
    """Zero statistics in the reference's tree and shapes (module doc;
    ``n_slots`` and ``n_tail`` are the model's ``len(cfg.pattern)`` and
    ``len(cfg.tail_pattern)``) and step 0."""
    stats = {}
    for k, p in params.items():
        if k == "layers":
            slots, tail = _layout(p, n_slots, n_tail)
            stats[k] = {str(i): _stacked_stats(s)
                        for i, s in enumerate(slots)}
            if tail:
                stats["tail"] = {str(i): unflatten(layer, [
                    _stats(tuple(t.shape), t.device) for t in leaves(layer)])
                    for i, layer in enumerate(tail)}
        elif k == "enc_layers":
            stats[k] = _stacked_stats(p)
        else:
            stats[k] = _stats(tuple(p.shape), p.device)
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


def _by_entry(ps: list, gs: list, s: dict, core):
    """The reference's ``lax.map`` branch: ``core`` on each entry along
    axis 0 (``ps`` / ``gs`` the entries), the statistics stacked."""
    outs = [core(p, g, {k: v[i] for k, v in s.items()})
            for i, (p, g) in enumerate(zip(ps, gs))]
    return [o[0] for o in outs], {k: torch.stack([o[1][k] for o in outs])
                                  for k in s}


def _leaf(p, g, s: dict, core):
    """The reference's ``leaf`` on one unstacked tensor."""
    if _grouped(tuple(p.shape)):
        ps, s2 = _by_entry(list(p.unbind(0)), list(g.unbind(0)), s, core)
        return torch.stack(ps), s2
    return core(p, g, s)


def _stacked_leaf(ps: list, gs: list, s: dict, core):
    """The reference's ``leaf`` on the stacked leaf whose G groups are
    the layer tensors ``ps``: new layer tensors and stacked statistics."""
    if _grouped((len(ps),) + tuple(ps[0].shape)):
        return _by_entry(ps, gs, s, core)
    p2, s2 = core(torch.stack(ps), torch.stack(gs), s)
    return list(p2.unbind(0)), s2


def _update_slot(slot: list, gslot: list, stats: dict, core):
    """The layers of one stacked slot updated as the reference's stacked
    leaves: (new layers, new stacked statistics)."""
    cols_p = [leaves(layer) for layer in slot]
    cols_g = [leaves(layer) for layer in gslot]
    outs = [_stacked_leaf([c[j] for c in cols_p], [c[j] for c in cols_g], s,
                          core)
            for j, s in enumerate(flatten_up_to(slot[0], stats))]
    return ([unflatten(slot[0], [o[0][g] for o in outs])
             for g in range(len(slot))],
            unflatten(slot[0], [o[1] for o in outs]))


def _update_unstacked(layer, grad, stats: dict, core):
    outs = [_leaf(p, g, s, core) for p, g, s in zip(
        leaves(layer), leaves(grad), flatten_up_to(layer, stats))]
    return (unflatten(layer, [o[0] for o in outs]),
            unflatten(layer, [o[1] for o in outs]))


def _update_layers(layers, grads, stats, core):
    """The decoder's per-layer parameter dicts updated slot by slot and
    tail layer by tail layer: (new layers, new ``layers`` statistics,
    new ``tail`` statistics)."""
    n_slots, n_tail = len(stats["layers"]), len(stats.get("tail", {}))
    slots, tail = _layout(layers, n_slots, n_tail)
    gslots, gtail = _layout(grads, n_slots, n_tail)
    n_grouped = len(layers) - n_tail
    new_layers = [None] * len(layers)
    new_stats = {}
    for i, (slot, gslot) in enumerate(zip(slots, gslots)):
        new, new_stats[str(i)] = _update_slot(slot, gslot,
                                              stats["layers"][str(i)], core)
        new_layers[i:n_grouped:n_slots] = new
    new_tail = {}
    for i, (layer, grad) in enumerate(zip(tail, gtail)):
        new_layers[n_grouped + i], new_tail[str(i)] = _update_unstacked(
            layer, grad, stats["tail"][str(i)], core)
    return new_layers, new_stats, new_tail


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
        if k == "layers":
            new_p[k], new_s[k], tail = _update_layers(p, grads[k], stats, core)
            if tail:
                new_s["tail"] = tail
        elif k == "enc_layers":
            new_p[k], new_s[k] = _update_slot(p, grads[k], stats[k], core)
        else:
            new_p[k], new_s[k] = _leaf(p, grads[k], stats[k], core)
    # the input trees' key order
    new_s = {k: new_s[k] for k in stats}
    return new_p, {"stats": new_s, "step": step}
