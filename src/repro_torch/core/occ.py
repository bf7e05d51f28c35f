"""Baseline OCC, *traditional transactions* (paper §2, Fig. 2a), after
``repro.core.occ``.

Traditional OCC ties the serialization order to the run-time
interleaving.  An explicit ``arrival`` permutation (which transaction
reaches its validation and write phase first) models that interleaving,
and the engine commits non-conflicting transactions in arrival-order
waves.  Each wave goes through the shared commit pipeline
(:mod:`repro_torch.core.protocol`): the read phase re-executes the
pending rows (gather-compacted below the full rung) and refreshes the
carried conflict table (the delta kernel at the full rung and the pair
kernel's strips below it, on CUDA); OCC's greedy rule (commit iff no
conflict with an earlier *committing* transaction, no prefix cut-off) is
the blocked fixpoint ``protocol.wave_commit``; one fused write-back
installs the wave.  With a ``seed`` (cross-batch pipelining), wave 0's
read phase is the re-based speculation (``protocol.seed_round_state``).

The final store depends on ``arrival``: other interleavings, other
outcomes.  That nondeterminism is what Pot removes.  The commit order is
recorded (``commit_pos``), so it can be replayed through
``ReplaySequencer`` (record/replay, paper §2.1).
"""

from __future__ import annotations

import torch

from repro_torch.core import protocol
from repro_torch.core.engine import (EngineDef, ExecTrace, make_trace,
                                     rank_from_order,
                                     register_engine)
from repro_torch.core.tstore import TStore, store_with
from repro_torch.core.txn import TxnBatch

_I32 = torch.int32

# the old per-engine trace name, kept as an alias of the one schema
OccTrace = ExecTrace


def _occ_execute(store: TStore, batch: TxnBatch, arrival: torch.Tensor,
                 max_waves: int | None = None,
                 incremental: bool = True,
                 compact: bool = True,
                 wave_block: int = 8,
                 seed: protocol.SpecSeed | None = None
                 ) -> tuple[TStore, ExecTrace]:
    """Execute a batch under OCC; ``arrival[p]`` is the transaction that
    reaches its commit p-th.

    Args:
      store: committed store of either layout; not modified (the engine works on a copy
             of its image).
      batch: K transactions on the store's device.  Rows with
             ``n_ins == 0`` are vacant: never pending, never committed,
             no ``gv`` advance; their arrival positions must come after
             every real row's.
      arrival: (K,) permutation.
      max_waves: wave limit (default K + 1, enough to commit all).
      incremental: re-execute only the pending rows each wave (False
             re-executes every row every wave).
      compact: run the waves as a cascade over
             ``protocol.compact_ladder(K)`` widths; only meaningful with
             ``incremental``.
      wave_block: conflict queries per ``wave_commit`` trip.
      seed:  a :class:`protocol.SpecSeed`: wave 0 ran against an earlier
             store and is re-based (see :mod:`repro_torch.core.pcc`); the
             store and trace equal the unseeded call's but for the
             ``spec_*`` fields.
    Returns:
      (new store, trace); ``new_store.gv`` is ``store.gv`` plus the
      number of committed transactions.  The decisions are the same for
      every setting of the three knobs; ``wave_trips`` and the work
      counters are what they change.
    """
    k = batch.n_txns
    dev = store.device
    layout = store.layout     # dense or S contiguous range shards
    n_obj = layout.n_objects
    rank = rank_from_order(arrival)
    gv0 = int(store.gv)
    real = batch.n_ins > 0
    limit = max_waves if max_waves is not None else k + 1
    tr = dict(commit_pos=torch.full((k,), -1, dtype=_I32, device=dev),
              retries=torch.zeros((k,), dtype=_I32, device=dev),
              exec_ops=torch.zeros((), dtype=_I32, device=dev),
              wave_trips=0,
              live_per_round=torch.full((limit,), -1, dtype=_I32,
                                        device=dev))

    def wave_body_at(width: int):
        full_rung = width >= k

        def wave_body(state):
            rs, done, n_comm, wave = state
            pending_t = ~done
            live = pending_t if incremental else torch.ones_like(real)
            if seed is not None and wave == 0:
                # wave 0 ran speculatively and was re-based onto this
                # store: charge its accounting without re-walking
                rs = protocol.charge_round_state(rs, batch, live, width)
            elif full_rung:
                rs = protocol.refresh_round_state(rs, batch, live, layout)
            else:
                rs = protocol.refresh_round_state_compact(
                    rs, batch, live, width, layout)[0]
            res = rs.res

            committing_t, trips = protocol.wave_commit(
                res, rs.conflict, pending_t, rank, n_obj, block=wave_block)

            # commit position = running count in arrival order, gathered
            # back through each txn's rank; torch's cumsum of a bool is
            # int64, the stamps are int32 as in the reference
            commit_idx_t = (n_comm + torch.cumsum(committing_t[arrival],
                                                  0)[rank] - 1).to(_I32)
            values, versions = protocol.fused_write_back(
                rs.values, rs.versions, res.waddrs, res.wvals, res.wn,
                committing_t, rank, gv0 + commit_idx_t + 1, layout)

            tr["commit_pos"] = torch.maximum(
                tr["commit_pos"],
                torch.where(committing_t, commit_idx_t, -1).to(_I32))
            tr["retries"] = tr["retries"] + (pending_t & ~committing_t)
            tr["exec_ops"] = tr["exec_ops"] + torch.where(
                pending_t, batch.n_ins, 0).sum(dtype=_I32)
            tr["wave_trips"] += trips
            tr["live_per_round"][wave] = live.sum(dtype=_I32)
            rs = protocol.commit_round_state(rs, values, versions)
            return (rs, done | committing_t,
                    n_comm + int(committing_t.sum()), wave + 1)

        return wave_body

    def cond_at(next_width: int):
        def cond(state):
            _, done, _, wave = state
            n_pending = int((~done).sum())
            go = n_pending > 0 and wave < limit
            if next_width:
                # hand over to the narrower rung once the pending set fits
                go = go and n_pending > next_width
            return go

        return cond

    if seed is not None:
        rs0, spec_inv, spec_rnds = protocol.seed_round_state(
            batch, store, seed, compact=(incremental and compact))
        spec = dict(spec_executed=real.sum(dtype=_I32),
                    spec_invalidated=spec_inv, spec_rounds=spec_rnds)
    else:
        rs0 = protocol.init_round_state(batch, store.values.clone(),
                                        store.versions.clone(),
                                        layout=layout)
        spec = {}
    ladder = (protocol.compact_ladder(k) if (incremental and compact)
              else [k])
    rs, done, n_comm, wave = protocol.run_compact_cascade(
        ladder, (rs0, ~real, 0, 0), wave_body_at, cond_at)

    trace = make_trace(
        k, device=dev,
        commit_pos=tr["commit_pos"], retries=tr["retries"],
        rounds=torch.tensor(wave, dtype=_I32, device=dev),
        exec_ops=tr["exec_ops"],
        wave_trips=torch.tensor(tr["wave_trips"], dtype=_I32, device=dev),
        live_txns=rs.live_txns, live_slots=rs.live_slots,
        walked_slots=rs.walked_slots,
        live_per_round=tr["live_per_round"],
        # a txn that retried r waves committed in wave r (vacant: none)
        commit_round=torch.where(real, tr["retries"], -1).to(_I32), **spec)
    gv = torch.tensor(gv0 + n_comm, dtype=_I32, device=dev)
    return store_with(store, rs.values, rs.versions, gv), trace


occ_execute = _occ_execute


def _occ_raw(store, batch, seq, lanes, n_lanes):
    del lanes, n_lanes
    # OCC has no preordering: the sequence order IS the arrival
    # interleaving, the run-time knob its outcome depends on
    return _occ_execute(store, batch, torch.argsort(seq, stable=True))


def _occ_raw_spec(store, batch, seq, lanes, n_lanes, seed):
    del lanes, n_lanes
    return _occ_execute(store, batch, torch.argsort(seq, stable=True),
                        seed=seed)


register_engine(EngineDef(
    "occ", _occ_raw,
    doc="traditional OCC baseline — commit order = arrival interleaving",
    raw_spec=_occ_raw_spec))
