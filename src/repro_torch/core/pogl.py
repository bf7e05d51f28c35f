"""PoGL, the Preordered Global Lock (paper §4.1.2), after
``repro.core.pogl``.

Transactions execute strictly one after another in the sequence order,
with no speculation: deterministic by construction, with no parallelism.
It is the serial oracle every other deterministic engine must equal
bitwise.  The reference's ``lax.scan`` over positions is a host loop:
each step runs one row through the VM (``txn.run_txn``) against the
running image and installs its writes (``protocol.apply_writes``) in
place, stamped with the row's position.

With a ``seed`` (cross-batch pipelining) the walk reuses a row's
re-based speculative result unless an earlier row of this batch wrote
an address it read (:func:`_pogl_seeded`); the store and trace equal the
unseeded walk's but for the ``spec_*`` fields, where the rows this
batch's own order forced to re-run count as invalidated beside the
cross-batch ones.  The test needs the host once per row.
"""

from __future__ import annotations

import torch

from repro_torch.core import protocol
from repro_torch.core.engine import (MODE_FAST, EngineDef, make_trace,
                                     rank_from_order, register_engine)
from repro_torch.core.txn import TxnResult
from repro_torch.core.tstore import TStore, flat_values, store_with
from repro_torch.core.txn import TxnBatch, run_txn

_I32 = torch.int32


def _pogl_ordered(store: TStore, batch: TxnBatch,
                  order: torch.Tensor) -> TStore:
    """Walk every row in ``order`` (vacant rows run as no-ops) on a copy
    of the store's image; ``gv`` advances by K."""
    layout = store.layout
    values, versions = store.values.clone(), store.versions.clone()
    gv0 = int(store.gv)
    for p, t in enumerate(order.tolist()):
        _, _, waddrs, wvals, wn = run_txn(
            batch.rows(t), flat_values(values, layout), layout.n_objects)
        protocol.apply_writes(values, versions, waddrs, wvals, wn,
                              gv0 + p + 1, layout)
    gv = torch.tensor(gv0 + batch.n_txns, dtype=_I32, device=store.device)
    return store_with(store, values, versions, gv)


def _pogl_seeded(store: TStore, batch: TxnBatch, order: torch.Tensor,
                 res: TxnResult) -> tuple[TStore, int]:
    """The serial walk over re-based speculative rows ``res`` (each equal
    to the row run against the batch-start image).  A cached row is
    reused unless an EARLIER row of this batch wrote an address it read
    (reads alone decide, as in ``protocol.speculation_invalid``); such a
    row re-executes against the running image.  ``gv`` advances by K as
    in :func:`_pogl_ordered`.  Returns the store and the number of rows
    re-executed."""
    layout = store.layout
    values, versions = store.values.clone(), store.versions.clone()
    gv0 = int(store.gv)
    n_obj = layout.n_objects
    written = torch.zeros((n_obj,), dtype=torch.bool, device=store.device)
    slot = torch.arange(batch.max_ins, device=store.device)
    n_rerun = 0
    for p, t in enumerate(order.tolist()):
        valid = slot < res.rn[t]
        ra = torch.where(valid, res.raddrs[t], 0).long()
        if bool((written[ra] & valid).any()):
            _, _, waddrs, wvals, wn = run_txn(
                batch.rows(t), flat_values(values, layout), n_obj)
            n_rerun += 1
        else:
            waddrs, wvals, wn = res.waddrs[t], res.wvals[t], res.wn[t]
        protocol.apply_writes(values, versions, waddrs, wvals, wn,
                              gv0 + p + 1, layout)
        protocol.mark_writes(written, waddrs, wn)
    gv = torch.tensor(gv0 + batch.n_txns, dtype=_I32, device=store.device)
    return store_with(store, values, versions, gv), n_rerun


def pogl_execute(store: TStore, batch: TxnBatch,
                 seq: torch.Tensor) -> TStore:
    """Execute ``batch`` serially in the order of ``seq``; returns the new
    store (the input store is not modified)."""
    return _pogl_ordered(store, batch, torch.argsort(seq, stable=True))


def _pogl_raw(store, batch, seq, lanes, n_lanes, seed=None):
    del lanes, n_lanes   # PoGL has no lane structure
    order = torch.argsort(seq, stable=True)
    rank = rank_from_order(order)
    # vacant rows (bucket padding, n_ins == 0; they sort after every real
    # row) execute as no-ops but never commit: no gv advance, no position
    real = batch.n_ins > 0
    n_real = real.sum(dtype=_I32)
    if seed is not None:
        rs, spec_inv, spec_rnds = protocol.seed_round_state(batch, store,
                                                            seed)
        out, n_rerun = _pogl_seeded(store, batch, order, rs.res)
        spec = dict(spec_executed=n_real,
                    spec_invalidated=spec_inv + n_rerun,
                    spec_rounds=spec_rnds)
    else:
        out = _pogl_ordered(store, batch, order)
        spec = {}
    at_rank = torch.where(real, rank, -1).to(_I32)
    # one txn per serial "round", uninstrumented (global lock = fast path)
    trace = make_trace(
        batch.n_txns, device=store.device,
        commit_round=at_rank, commit_pos=at_rank, first_round=at_rank,
        mode=torch.where(real, MODE_FAST, 0).to(_I32),
        rounds=n_real, exec_ops=batch.n_ins.sum(dtype=_I32), **spec)
    return store_with(out, out.values, out.versions, store.gv + n_real), trace


def _pogl_raw_spec(store, batch, seq, lanes, n_lanes, seed):
    return _pogl_raw(store, batch, seq, lanes, n_lanes, seed=seed)


register_engine(EngineDef(
    "pogl", _pogl_raw,
    doc="Preordered Global Lock — strictly serial in sequence order",
    raw_spec=_pogl_raw_spec))
