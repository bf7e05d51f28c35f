"""Carry state between the reference package and the port, as numpy.

This system has no weights: its state is the store and the batches, and
its result the store and the traces.  ``*_from_numpy`` builds the port's
object from anything holding the fields as arrays (a mapping, or an
object with the attributes — the reference's own ``TStore``,
``TxnBatch`` or ``ExecTrace`` qualify, since ``np.asarray`` reads their
arrays); ``*_to_numpy`` returns a dict of numpy arrays that the
reference's constructors accept after ``jnp.asarray``.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import numpy as np
import torch

from repro_torch.core.engine import ExecTrace
from repro_torch.core.tstore import TStore
from repro_torch.core.txn import TxnBatch


def _field(src, name: str) -> np.ndarray:
    return np.asarray(src[name] if isinstance(src, Mapping)
                      else getattr(src, name))


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
