"""Carry state between the reference package and the port, as numpy.

The transactional core has no weights: its state is the store and the
batches, and its result the store and the traces.  ``*_from_numpy``
builds the port's
object from anything holding the fields as arrays (a mapping, or an
object with the attributes — the reference's own ``TStore``,
``TxnBatch`` or ``ExecTrace`` qualify, since ``np.asarray`` reads their
arrays); ``*_to_numpy`` returns a dict of numpy arrays that the
reference's constructors accept after ``jnp.asarray``.

A cross-batch speculation seed crosses with :func:`seed_from_numpy` /
:func:`seed_to_numpy`, and an ingress-formed batch with
:func:`formed_batch_from_numpy` / :func:`formed_batch_to_numpy`, so that
both packages can be handed the same seed and the same batches.

The serving path's LM weights cross with :func:`lm_params_from_numpy`
and its decode caches with :func:`lm_cache_from_numpy` /
:func:`lm_cache_to_numpy`, the training path's whole state (weights, the AdamW moments or the
Adafactor statistics, and the counters) with
:func:`train_state_from_numpy`.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import numpy as np
import torch

from repro_torch.core.engine import ExecTrace
from repro_torch.core.ingress import FormedBatch
from repro_torch.core.protocol import SpecSeed
from repro_torch.core.tstore import TStore
from repro_torch.core.txn import TxnBatch, TxnResult
from repro_torch.models import lm
from repro_torch.models.blocks import C
from repro_torch.models.config import ModelConfig
from repro_torch.optim.adafactor import adafactor_init
from repro_torch.runtime.shardings import SMOKE, Profile, local_tree
from repro_torch.train.train_step import TrainState, opt_specs
from repro_torch.tree import tree_map


def _field_tree(src, name: str):
    return src[name] if isinstance(src, Mapping) else getattr(src, name)


def _field(src, name: str) -> np.ndarray:
    return np.asarray(_field_tree(src, name))


def _from_numpy(cls, src, device, dtypes=None):
    dtypes = dtypes or {}
    return cls(**{
        f.name: torch.from_numpy(np.array(
            _field(src, f.name), dtype=dtypes.get(f.name, np.int32))
        ).to(device)
        for f in dataclasses.fields(cls)})


def _to_numpy(obj) -> dict[str, np.ndarray]:
    return {f.name: getattr(obj, f.name).cpu().numpy()
            for f in dataclasses.fields(obj)}


def store_from_numpy(src, device="cuda") -> TStore:
    """A dense store from ``values`` (O, S), ``versions`` (O,), ``gv``."""
    return _from_numpy(TStore, src, device)


def store_to_numpy(store: TStore) -> dict[str, np.ndarray]:
    return _to_numpy(store)


def batch_from_numpy(src, device="cuda") -> TxnBatch:
    """A batch from ``opcodes``, ``addrs``, ``indirect``, ``operands``
    (K, L) and ``n_ins`` (K,)."""
    return _from_numpy(TxnBatch, src, device, {"indirect": bool})


def batch_to_numpy(batch: TxnBatch) -> dict[str, np.ndarray]:
    return _to_numpy(batch)


def trace_from_numpy(src, device="cuda") -> ExecTrace:
    """A trace from every ExecTrace field."""
    return _from_numpy(ExecTrace, src, device)


def trace_to_numpy(trace: ExecTrace) -> dict[str, np.ndarray]:
    return _to_numpy(trace)


_SEED_TABLES = {"conflict": bool, "foot_bits": np.int32,
                "write_bits": np.int32}


def seed_from_numpy(src, device="cuda") -> SpecSeed:
    """A speculation seed from ``res`` (the five TxnResult fields),
    ``conflict`` / ``foot_bits`` / ``write_bits`` (arrays, or None where
    the formulation carries no table) and ``snap_gv``; the reference's own
    ``SpecSeed`` qualifies."""
    tables = {}
    for name, dtype in _SEED_TABLES.items():
        a = _field_tree(src, name)
        tables[name] = None if a is None else torch.from_numpy(
            np.array(a, dtype=dtype)).to(device)
    return SpecSeed(res=_from_numpy(TxnResult, _field_tree(src, "res"),
                                    device),
                    snap_gv=torch.from_numpy(np.array(
                        _field(src, "snap_gv"), np.int32)).to(device),
                    **tables)


def seed_to_numpy(seed: SpecSeed) -> dict:
    """A seed as numpy: ``res`` a dict of its five fields, a table None
    where the seed has none."""
    out = {name: None if getattr(seed, name) is None
           else getattr(seed, name).cpu().numpy() for name in _SEED_TABLES}
    return dict(out, res=_to_numpy(seed.res),
                snap_gv=seed.snap_gv.cpu().numpy())


_FORMED_ARRAYS = ("lanes", "seq", "txn_ids", "stamps")


def formed_batch_from_numpy(src, device="cpu") -> FormedBatch:
    """An ingress-formed batch from ``batch`` (the TxnBatch fields),
    ``lanes``, ``seq``, ``txn_ids``, ``stamps`` (int64), ``ladder`` and
    ``budget``; the reference's own ``FormedBatch`` qualifies.  The pool
    forms batches on the host, so the batch stays on the CPU unless
    ``device`` says otherwise."""
    return FormedBatch(
        batch=batch_from_numpy(_field_tree(src, "batch"), device),
        **{f: np.array(_field(src, f), np.int64) for f in _FORMED_ARRAYS},
        ladder=str(_field_tree(src, "ladder")),
        budget=int(_field_tree(src, "budget")))


def formed_batch_to_numpy(fb: FormedBatch) -> dict:
    return dict(batch=batch_to_numpy(fb.batch),
                **{f: np.asarray(getattr(fb, f)) for f in _FORMED_ARRAYS},
                ladder=fb.ladder, budget=fb.budget)


def lm_params_from_numpy(tree, cfg: ModelConfig, device="cuda",
                         dtype=C, prof: Profile = SMOKE) -> dict:
    """The port's LM parameters from the reference's parameter tree as
    numpy (``jax.tree.map(np.asarray, params)``).

    Each ``layers["i"]`` leaf of shape (G, ...) is unstacked into one
    parameter dict per layer (layer ``g * len(pattern) + i``), the
    ``tail`` layers follow, and an encoder's ``enc_layers`` (G_enc, ...)
    are unstacked into ``enc_layers``.  Values are stored in ``dtype``:
    bf16 by default, which is what the reference's ``_cast`` makes of
    every float32 parameter at each use, so no bit changes; float32
    keeps the training path's masters.  Under a ``prof`` with a mesh the
    tree is this rank's (``lm.local_params``): every leaf cut to the
    rank's shard by its spec."""
    def tensor(a):
        return torch.from_numpy(np.array(a, np.float32)).to(
            device=device, dtype=dtype)

    def unstack(stacked):
        n = np.shape(stacked["ln1"])[0]
        return [tree_map(lambda a: tensor(np.asarray(a)[g]), stacked)
                for g in range(n)]

    out = {k: tensor(tree[k]) for k in ("embed", "final_norm", "head")
           if k in tree}
    groups = [unstack(tree["layers"][str(i)])
              for i in range(len(cfg.pattern))]
    out["layers"] = [slot[g] for g in range(cfg.n_groups) for slot in groups]
    out["layers"] += [tree_map(tensor, tree["tail"][str(i)])
                      for i in range(len(cfg.tail_pattern))]
    if "enc_layers" in tree:
        out["enc_layers"] = unstack(tree["enc_layers"])
        out["enc_norm"] = tensor(tree["enc_norm"])
    return lm.local_params(out, cfg, prof)


_KV = ("k", "v", "xk", "xv")


def lm_cache_from_numpy(tree, cfg: ModelConfig, device="cuda",
                        dtype=C) -> list:
    """The port's decode cache (one dict per layer, ``lm.init_cache``'s
    layout) from the reference's cache tree as numpy (from its
    ``init_cache`` or ``prefill``): each slot's (G, ...) leaves
    unstacked in the reference's layer order, the tail's after them,
    and an encoder-decoder's ``cross_k`` / ``cross_v`` (G, ...) spread
    to each group's layer as ``xk`` / ``xv``.  K/V rows are stored in
    ``dtype``, the recurrent states in float32."""
    def tensor(name, a):
        return torch.from_numpy(np.array(a, np.float32)).to(
            device=device, dtype=dtype if name in _KV else torch.float32)

    def layer(slot, g=None):
        pick = (lambda a: a) if g is None else (lambda a: np.asarray(a)[g])
        c = {name: tensor(name, pick(a)) for name, a in slot.items()}
        if "cross_k" in tree and g is not None:
            c["xk"] = tensor("xk", pick(tree["cross_k"]))
            c["xv"] = tensor("xv", pick(tree["cross_v"]))
        return c

    out = [layer(tree[str(i)], g) for g in range(cfg.n_groups)
           for i in range(len(cfg.pattern))]
    return out + [layer(tree["tail"][str(i)])
                  for i in range(len(cfg.tail_pattern))]


def lm_cache_to_numpy(cache: list, cfg: ModelConfig) -> dict:
    """The reference's cache tree (float32 numpy) from the port's cache:
    the inverse of :func:`lm_cache_from_numpy`.  bf16 rows become
    float32 without loss; cast them back for the reference with
    ``jnp.asarray(a, jnp.bfloat16)``."""
    host = lambda t: t.float().cpu().numpy()
    p, g = len(cfg.pattern), cfg.n_groups
    tree = {}
    for i in range(p):
        rows = [cache[j * p + i] for j in range(g)]
        tree[str(i)] = {name: np.stack([host(c[name]) for c in rows])
                        for name in rows[0] if name not in ("xk", "xv")}
    if cfg.encoder_layers:
        for name, key in (("xk", "cross_k"), ("xv", "cross_v")):
            tree[key] = np.stack([host(cache[j * p][name])
                                  for j in range(g)])
    if cfg.tail_pattern:
        tree["tail"] = {str(i): {name: host(t) for name, t in c.items()}
                        for i, c in enumerate(cache[p * g:])}
    return tree


def _tensors_like(like, src, device, path="stats"):
    """float32 tensors of ``src`` (numpy, nested dicts) in the structure
    and key order of the port's tree ``like``; raises ``ValueError`` where
    a key or a shape differs."""
    if isinstance(like, dict):
        if set(like) != set(src):
            raise ValueError(f"{path}: keys {sorted(src)} where the port "
                             f"holds {sorted(like)}")
        return {k: _tensors_like(v, src[k], device, f"{path}/{k}")
                for k, v in like.items()}
    a = np.array(src, np.float32)
    if a.shape != tuple(like.shape):
        raise ValueError(f"{path}: shape {a.shape} where the port holds "
                         f"{tuple(like.shape)}")
    return torch.from_numpy(a).to(device)


def train_state_from_numpy(tree, cfg: ModelConfig, device="cuda",
                           prof: Profile = SMOKE) -> TrainState:
    """The port's ``TrainState`` from the reference's ``TrainState`` (or a
    mapping with its fields) as numpy: parameters and AdamW moments
    unstacked as :func:`lm_params_from_numpy` unstacks them and kept in
    float32; Adafactor's statistics (``opt["stats"]``) kept in their
    stacked shapes, the ``tail`` and ``enc_layers`` ones too, as the
    port's Adafactor holds them (a missing or extra statistic, or one of
    another shape, raises ``ValueError``);
    ``opt["step"]``, ``gv`` and ``step`` as 0-d int32 tensors.  Under a
    ``prof`` with a mesh, a rank's state: the parameters and moments cut
    as :func:`lm_params_from_numpy` cuts them, each Adafactor statistic
    by its spec (``train_step.opt_specs``: a leaf's ``vr`` by the leaf's
    spec without its last entry, its ``vc`` without its second last)."""
    f32 = lambda t: lm_params_from_numpy(t, cfg, device, torch.float32)
    cut = lambda t: lm.local_params(t, cfg, prof)
    i32 = lambda a: torch.tensor(int(np.asarray(a)), dtype=torch.int32,
                                 device=device)
    opt = _field_tree(tree, "opt")
    params = f32(_field_tree(tree, "params"))
    if "stats" in opt:
        like = adafactor_init(params, len(cfg.pattern),
                              len(cfg.tail_pattern))["stats"]
        stats = _tensors_like(like, opt["stats"], device)
        if lm.on_mesh(prof):
            specs = opt_specs(lm.param_specs(cfg, prof), params,
                              "adafactor", cfg)["stats"]
            stats = local_tree(stats, specs, prof.mesh)
        state = {"stats": stats}
    else:
        state = {"m": cut(f32(opt["m"])), "v": cut(f32(opt["v"]))}
    return TrainState(params=cut(params),
                      opt=dict(state, step=i32(opt["step"])),
                      gv=i32(_field(tree, "gv")), step=i32(_field(tree, "step")))
