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

**On a mesh** (``specs`` and ``mesh`` given: the parameters' spec tree,
``lm.param_specs``, and the ``DeviceMesh``) each rank updates the
shards it holds, with the statistics of its shards' shapes
(:func:`adafactor_init` on its parameters), and every statistic, the
``denom`` and the RMS clip are the whole leaf's, as in the reference:
each mean over a dim is the mean of the rank's shard, summed on the
fixed ring (``ordered_ring_reduce``) over the groups of the mesh axes
that cut that dim (each axis of a tuple entry in turn, in the mesh's
order), and divided by the number of shards along it.  The shards are
equal, so that is the whole mean; on an axis of one the sum is the
identity and the division by one exact, so one body is the dense
update bit for bit off a mesh and at world 1, and every rank that holds
a replica of a leaf or statistic gets the same bits.  The grouped clip
is chosen from the whole leaf's shape, never the shard's.

``step`` is a 0-d int32 tensor on the parameters' device; ``beta2 = 1 -
step^-0.8`` is computed from it there, in float32.
"""

from __future__ import annotations

import math
from functools import partial

import torch

from repro_torch.optim.ordered_reduce import ordered_ring_reduce
from repro_torch.tree import flatten_up_to, leaves, unflatten

_GROUPED_ABOVE = 2e8   # elements of a stacked leaf clipped group by group


def _factored(shape) -> bool:
    return len(shape) >= 2


def _grouped(shape) -> bool:
    """The reference's choice of the clip entry by entry along axis 0,
    from the whole leaf's ``shape``."""
    return (len(shape) >= 3 and shape[0] > 1
            and math.prod(shape) > _GROUPED_ABOVE)


def _cut(spec, mesh, ndim: int) -> tuple:
    """How ``spec`` cuts a leaf of ``ndim`` dims over ``mesh``: for each
    dim, (the process groups of the mesh axes over it, in the mesh's
    order; the number of shards along it).  Nothing is cut without a
    mesh."""
    if mesh is None:
        return (((), 1),) * ndim
    # imported here: runtime.shardings imports this package
    from repro_torch.runtime.shardings import shard_dims
    names = tuple(mesh.mesh_dim_names)
    groups, ways = [()] * ndim, [1] * ndim
    for i, dim in enumerate(shard_dims(spec, names, ndim)):
        if dim is not None:
            groups[dim] += (mesh.get_group(names[i]),)
            ways[dim] *= mesh.size(i)
    return tuple(zip(groups, ways))


def _whole(shape, cut) -> tuple:
    """The whole leaf's shape from a shard's ``shape`` and its cut."""
    return tuple(n * ways for n, (_, ways) in zip(shape, cut, strict=True))


def _mean(t, cut, dim=None, keepdim=False):
    """The whole leaf's mean of ``t`` (cut by ``cut``) over ``dim``, every
    dim where None, from the rank's shard (module doc)."""
    out = t.mean() if dim is None else t.mean(dim=dim, keepdim=keepdim)
    n = 1
    for groups, ways in (cut if dim is None else (cut[dim],)):
        for group in groups:
            out = ordered_ring_reduce(out, group)
        n *= ways
    return out / n


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


def _leaf_core(p, g, s, cut=None, *, beta2, lr, eps, clip_threshold, wd):
    """The reference's ``leaf_core``: one leaf's statistics, clipped
    update and new value, the means the whole leaf's where ``cut`` says
    how a mesh cuts it (:func:`_cut`; nothing cut by default)."""
    cut = _cut(None, None, p.dim()) if cut is None else cut
    g = g.float()
    g2 = g * g + eps
    if _factored(p.shape):
        vr = beta2 * s["vr"] + (1 - beta2) * _mean(g2, cut, -1)
        vc = beta2 * s["vc"] + (1 - beta2) * _mean(g2, cut, -2)
        denom = _mean(vr, cut[:-1], -1, keepdim=True)
        u = g * torch.rsqrt(vr[..., None] / denom[..., None]) \
            * torch.rsqrt(vc[..., None, :])
        new_s = {"vr": vr, "vc": vc}
    else:
        v = beta2 * s["v"] + (1 - beta2) * g2
        u = g * torch.rsqrt(v)
        new_s = {"v": v}
    # update clipping (RMS(u) <= clip_threshold)
    rms = torch.sqrt(_mean(u * u, cut) + 1e-30)
    u = u / torch.clamp(rms / clip_threshold, min=1.0)
    pf = p.float()
    p2 = pf - lr * u - lr * wd * pf
    return p2.to(p.dtype), new_s


def _by_entry(ps: list, gs: list, s: dict, cut, core):
    """The reference's ``lax.map`` branch: ``core`` on each entry along
    axis 0 (``ps`` / ``gs`` the entries; ``cut`` the stacked leaf's),
    the statistics stacked."""
    outs = [core(p, g, {k: v[i] for k, v in s.items()}, cut[1:])
            for i, (p, g) in enumerate(zip(ps, gs))]
    return [o[0] for o in outs], {k: torch.stack([o[1][k] for o in outs])
                                  for k in s}


def _leaf(p, g, s: dict, cut, core):
    """The reference's ``leaf`` on one unstacked tensor."""
    if _grouped(_whole(p.shape, cut)):
        ps, s2 = _by_entry(list(p.unbind(0)), list(g.unbind(0)), s, cut,
                           core)
        return torch.stack(ps), s2
    return core(p, g, s, cut)


def _stacked_leaf(ps: list, gs: list, s: dict, cut, core):
    """The reference's ``leaf`` on the stacked leaf whose G groups are
    the layer tensors ``ps`` (each cut by ``cut``; the group axis is
    whole): new layer tensors and stacked statistics."""
    cut = (((), 1),) + cut
    if _grouped(_whole((len(ps),) + tuple(ps[0].shape), cut)):
        return _by_entry(ps, gs, s, cut, core)
    p2, s2 = core(torch.stack(ps), torch.stack(gs), s, cut)
    return list(p2.unbind(0)), s2


def _update_slot(slot: list, gslot: list, stats: dict, cuts, core):
    """The layers of one stacked slot updated as the reference's stacked
    leaves (``cuts`` the tree of a layer's cuts): (new layers, new
    stacked statistics)."""
    cols_p = [leaves(layer) for layer in slot]
    cols_g = [leaves(layer) for layer in gslot]
    outs = [_stacked_leaf([c[j] for c in cols_p], [c[j] for c in cols_g], s,
                          cut, core)
            for j, (s, cut) in enumerate(zip(
                flatten_up_to(slot[0], stats), flatten_up_to(slot[0], cuts),
                strict=True))]
    return ([unflatten(slot[0], [o[0][g] for o in outs])
             for g in range(len(slot))],
            unflatten(slot[0], [o[1] for o in outs]))


def _update_unstacked(layer, grad, stats: dict, cuts, core):
    outs = [_leaf(p, g, s, cut, core) for p, g, s, cut in zip(
        leaves(layer), leaves(grad), flatten_up_to(layer, stats),
        flatten_up_to(layer, cuts), strict=True)]
    return (unflatten(layer, [o[0] for o in outs]),
            unflatten(layer, [o[1] for o in outs]))


def _update_layers(layers, grads, stats, cuts, core):
    """The decoder's per-layer parameter dicts updated slot by slot and
    tail layer by tail layer: (new layers, new ``layers`` statistics,
    new ``tail`` statistics)."""
    n_slots, n_tail = len(stats["layers"]), len(stats.get("tail", {}))
    slots, tail = _layout(layers, n_slots, n_tail)
    gslots, gtail = _layout(grads, n_slots, n_tail)
    cslots, ctail = _layout(cuts, n_slots, n_tail)
    n_grouped = len(layers) - n_tail
    new_layers = [None] * len(layers)
    new_stats = {}
    for i, (slot, gslot) in enumerate(zip(slots, gslots)):
        new, new_stats[str(i)] = _update_slot(
            slot, gslot, stats["layers"][str(i)], cslots[i][0], core)
        new_layers[i:n_grouped:n_slots] = new
    new_tail = {}
    for i, (layer, grad) in enumerate(zip(tail, gtail)):
        new_layers[n_grouped + i], new_tail[str(i)] = _update_unstacked(
            layer, grad, stats["tail"][str(i)], ctail[i], core)
    return new_layers, new_stats, new_tail


def adafactor_update(params, grads, state, *, lr=1e-2, eps=1e-30,
                     decay_pow=0.8, clip_threshold=1.0, wd=0.0, specs=None,
                     mesh=None):
    """One Adafactor step: returns ``(params', state')``, new trees; the
    inputs are left as they were.  With ``specs`` (the parameters' spec
    tree) and ``mesh``, ``params`` and the state are a rank's shards
    (module doc)."""
    step = state["step"] + 1
    beta2 = 1.0 - torch.pow(step.float(), -decay_pow)
    core = partial(_leaf_core, beta2=beta2, lr=lr, eps=eps,
                   clip_threshold=clip_threshold, wd=wd)
    specs = ([None] * len(leaves(params)) if mesh is None
             else flatten_up_to(params, specs))
    cuts = unflatten(params, [_cut(spec, mesh, t.ndim) for t, spec in zip(
        leaves(params), specs, strict=True)])
    stats = state["stats"]
    new_p, new_s = {}, {}
    for k, p in params.items():
        if k == "layers":
            new_p[k], new_s[k], tail = _update_layers(p, grads[k], stats,
                                                      cuts[k], core)
            if tail:
                new_s["tail"] = tail
        elif k == "enc_layers":
            new_p[k], new_s[k] = _update_slot(p, grads[k], stats[k],
                                              cuts[k][0], core)
        else:
            new_p[k], new_s[k] = _leaf(p, grads[k], stats[k], cuts[k], core)
    # the input trees' key order
    new_s = {k: new_s[k] for k in stats}
    return new_p, {"stats": new_s, "step": step}
