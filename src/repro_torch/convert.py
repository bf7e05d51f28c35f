"""Carry state between the reference package and the port, as numpy.

The transactional core has no weights: its state is the store and the
batches, and its result the store and the traces.  ``*_from_numpy``
builds the port's
object from anything holding the fields as arrays (a mapping, or an
object with the attributes — the reference's own ``TStore``,
``TxnBatch`` or ``ExecTrace`` qualify, since ``np.asarray`` reads their
arrays); ``*_to_numpy`` returns a dict of numpy arrays that the
reference's constructors accept after ``jnp.asarray``.

The serving path's LM weights cross with :func:`lm_params_from_numpy`,
the training path's whole state (weights, AdamW moments and counters)
with :func:`train_state_from_numpy`.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import numpy as np
import torch

from repro_torch.core.engine import ExecTrace
from repro_torch.core.tstore import TStore
from repro_torch.core.txn import TxnBatch
from repro_torch.models import lm
from repro_torch.models.blocks import C
from repro_torch.models.config import ModelConfig
from repro_torch.train.train_step import TrainState
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


def lm_params_from_numpy(tree, cfg: ModelConfig, device="cuda",
                         dtype=C) -> dict:
    """The port's LM parameters from the reference's parameter tree as
    numpy (``jax.tree.map(np.asarray, params)``).

    Each ``layers["i"]`` leaf of shape (G, ...) is unstacked into one
    parameter dict per layer (layer ``g * len(pattern) + i``).  Values
    are stored in ``dtype``: bf16 by default, which is what the
    reference's ``_cast`` makes of every float32 parameter at each use,
    so no bit changes; float32 keeps the training path's masters."""
    lm.check_supported(cfg)

    def tensor(a):
        return torch.from_numpy(np.array(a, np.float32)).to(
            device=device, dtype=dtype)

    out = {k: tensor(tree[k]) for k in ("embed", "final_norm", "head")
           if k in tree}
    n_groups = np.shape(tree["layers"]["0"]["ln1"])[0]
    out["layers"] = [
        tree_map(lambda a: tensor(np.asarray(a)[g]), tree["layers"][str(i)])
        for g in range(n_groups) for i in range(len(cfg.pattern))]
    return out


def train_state_from_numpy(tree, cfg: ModelConfig,
                           device="cuda") -> TrainState:
    """The port's ``TrainState`` from the reference's ``TrainState`` (or a
    mapping with its fields) as numpy: parameters and AdamW moments
    unstacked as :func:`lm_params_from_numpy` unstacks them and kept in
    float32; ``opt["step"]``, ``gv`` and ``step`` as 0-d int32 tensors."""
    f32 = lambda t: lm_params_from_numpy(t, cfg, device, torch.float32)
    i32 = lambda a: torch.tensor(int(np.asarray(a)), dtype=torch.int32,
                                 device=device)
    opt = _field_tree(tree, "opt")
    return TrainState(
        params=f32(_field_tree(tree, "params")),
        opt={"m": f32(opt["m"]), "v": f32(opt["v"]),
             "step": i32(opt["step"])},
        gv=i32(_field(tree, "gv")), step=i32(_field(tree, "step")))
