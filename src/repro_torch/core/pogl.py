"""PoGL, the Preordered Global Lock (paper §4.1.2), after
``repro.core.pogl``.

Transactions execute strictly one after another in the sequence order,
with no speculation: deterministic by construction, with no parallelism.
It is the serial oracle every other deterministic engine must equal
bitwise.  The reference's ``lax.scan`` over positions is a host loop:
each step runs one row through the VM (``txn.run_txn``) against the
running image and installs its writes (``protocol.apply_writes``) in
place, stamped with the row's position.
"""

from __future__ import annotations

import torch

from repro_torch.core import protocol
from repro_torch.core.engine import (MODE_FAST, EngineDef, make_trace,
                                     rank_from_order, register_engine)
from repro_torch.core.tstore import TStore, store_with
from repro_torch.core.txn import TxnBatch, run_txn

_I32 = torch.int32


def _pogl_ordered(store: TStore, batch: TxnBatch,
                  order: torch.Tensor) -> TStore:
    """Walk every row in ``order`` (vacant rows run as no-ops) on a copy
    of the store's image; ``gv`` advances by K."""
    values, versions = store.values.clone(), store.versions.clone()
    gv0 = int(store.gv)
    for p, t in enumerate(order.tolist()):
        _, _, waddrs, wvals, wn = run_txn(batch.rows(t), values,
                                          store.n_objects)
        protocol.apply_writes(values, versions, waddrs, wvals, wn,
                              gv0 + p + 1)
    gv = torch.tensor(gv0 + batch.n_txns, dtype=_I32, device=store.device)
    return store_with(store, values, versions, gv)


def pogl_execute(store: TStore, batch: TxnBatch,
                 seq: torch.Tensor) -> TStore:
    """Execute ``batch`` serially in the order of ``seq``; returns the new
    store (the input store is not modified)."""
    return _pogl_ordered(store, batch, torch.argsort(seq, stable=True))


def _pogl_raw(store, batch, seq, lanes, n_lanes):
    del lanes, n_lanes   # PoGL has no lane structure
    order = torch.argsort(seq, stable=True)
    rank = rank_from_order(order)
    # vacant rows (bucket padding, n_ins == 0; they sort after every real
    # row) execute as no-ops but never commit: no gv advance, no position
    real = batch.n_ins > 0
    n_real = real.sum(dtype=_I32)
    out = _pogl_ordered(store, batch, order)
    at_rank = torch.where(real, rank, -1).to(_I32)
    # one txn per serial "round", uninstrumented (global lock = fast path)
    trace = make_trace(
        batch.n_txns, device=store.device,
        commit_round=at_rank, commit_pos=at_rank, first_round=at_rank,
        mode=torch.where(real, MODE_FAST, 0).to(_I32),
        rounds=n_real, exec_ops=batch.n_ins.sum(dtype=_I32))
    return store_with(out, out.values, out.versions, store.gv + n_real), trace


register_engine(EngineDef(
    "pogl", _pogl_raw,
    doc="Preordered Global Lock — strictly serial in sequence order"))
