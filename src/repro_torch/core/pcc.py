"""Pot Concurrency Control (PCC), the paper's contribution (§2.2), after
``repro.core.pcc``.

Each round is three batched stages over the pending suffix of the
serialization order:

1. **Read phase** — the pending transactions re-execute against the
   committed image (``protocol.refresh_round_state``; below the full
   rung, gather-compacted at the rung's width), and the carried conflict
   table is delta-updated: by the delta kernel at the full rung and by
   the pair kernel's two strips at the compact rungs (matrix
   formulation, CUDA), or not at all (scatter-min formulation, CPU).
2. **Prefix decision** — ``protocol.prefix_commit``: the maximal in-order
   prefix with no conflict against an earlier pending transaction.
3. **Fused write-back** of that prefix, then **live promotion**
   (§2.2.3): the first pending transaction left is now the fast
   transaction; it re-executes against the fresh image and commits
   unconditionally in the same round.

The reference's ``lax.while_loop`` cascade is a host loop: each round
reads back one count (how many committed) to decide the next.  The
result depends only on (store, transactions, sequence order).
"""

from __future__ import annotations

import torch

from repro_torch.core import protocol
from repro_torch.core.engine import (MODE_FAST, MODE_PREFIX, MODE_SPEC,
                                     MODE_UNSET, EngineDef, ExecTrace,
                                     make_trace, rank_from_order,
                                     register_engine)
from repro_torch.core.tstore import TStore, store_with
from repro_torch.core.txn import TxnBatch, run_txn

_I32 = torch.int32
_INT32_MAX = torch.iinfo(torch.int32).max


def _pcc_execute(store: TStore, batch: TxnBatch, seq: torch.Tensor,
                 max_rounds: int | None = None,
                 live_promotion: bool = True,
                 incremental: bool = True,
                 compact: bool = True) -> tuple[TStore, ExecTrace]:
    """Execute a batch of preordered transactions under PCC.

    Args:
      store: committed TStore; not modified (the engine works on a copy
             of its image, updated in place round by round).
      batch: K transactions on the store's device.  Rows with
             ``n_ins == 0`` are vacant: never pending, never committed,
             no ``gv`` advance, ``commit_pos == -1``; their sequence
             numbers must sort after every real row's.
      seq:   (K,) 1-based sequence numbers from the sequencer.
      max_rounds: round limit (default K + 1, enough to commit all).
      live_promotion: commit the next pending transaction in fast mode
             after each prefix (False gives the Pot* ablation).
      incremental: re-execute only the pending suffix each round
             (False re-executes every row every round).
      compact: run the rounds as a cascade over
             ``protocol.compact_ladder(K)`` widths; only meaningful with
             ``incremental``.
    Returns:
      (new store, trace); ``new_store.gv`` is ``store.gv`` plus the
      number of committed transactions.
    """
    k = batch.n_txns
    dev = store.device
    n_obj = store.n_objects
    order = torch.argsort(seq, stable=True)  # order[p] = txn at position p
    rank = rank_from_order(order)
    gv0 = int(store.gv)
    seq_nos = gv0 + 1 + rank   # version stamp per txn (its seq position)
    real = batch.n_ins > 0     # vacant rows (bucket padding) never commit
    n_real = int(real.sum())
    limit = max_rounds if max_rounds is not None else k + 1

    full = lambda v: torch.full((k,), v, dtype=_I32, device=dev)
    zero = lambda: torch.zeros((), dtype=_I32, device=dev)
    tr = dict(
        commit_round=full(-1), first_round=full(_INT32_MAX),
        retries=full(0), mode=full(0), wait_rounds=full(0),
        validation_words=zero(), exec_ops=zero(), promotions=zero(),
        live_per_round=torch.full((limit,), -1, dtype=_I32, device=dev))

    def round_body_at(width: int):
        full_rung = width >= k

        def round_body(state):
            rs, n_comm, rnd = state

            # --- read phase: only pending txns re-execute; below the full
            # rung they execute gather-compacted at (width, L) ------------
            pending_t = real & (rank >= n_comm)
            live = pending_t if incremental else torch.ones_like(real)
            if full_rung:
                rs = protocol.refresh_round_state(rs, batch, live)
            else:
                rs = protocol.refresh_round_state_compact(
                    rs, batch, live, width)[0]
            res = rs.res

            # --- carried conflict analysis + prefix decision -------------
            committing_t = protocol.prefix_commit(
                res, rs.conflict, order, rank, n_comm, n_obj, real)

            # --- fused write-back: the whole prefix in one scatter -------
            values, versions = protocol.fused_write_back(
                rs.values, rs.versions, res.waddrs, res.wvals, res.wn,
                committing_t, rank, seq_nos)
            n_new = int(committing_t.sum())

            # --- live promotion (§2.2.3): the first non-committing pending
            # transaction re-executes against the fresh image and commits
            promoted_pos = -1
            if live_promotion and n_comm + n_new < n_real:
                head_pos = n_comm + n_new
                _, _, waddrs, wvals, wn = run_txn(
                    batch.rows(order[head_pos]), values, n_obj)
                protocol.apply_writes(values, versions, waddrs, wvals, wn,
                                      gv0 + head_pos + 1)
                promoted_pos = head_pos
                n_new += 1

            # --- trace bookkeeping: txn space, elementwise ---------------
            is_head_t = rank == n_comm
            promoted_t = rank == promoted_pos
            committing_all = committing_t | promoted_t
            waiting = pending_t & ~committing_all
            mode_t = torch.where(
                committing_all,
                torch.where(is_head_t | promoted_t, MODE_FAST, MODE_PREFIX),
                torch.where(pending_t, MODE_SPEC, MODE_UNSET)).to(_I32)
            tr["commit_round"] = torch.maximum(
                tr["commit_round"],
                torch.where(committing_all, rnd, -1).to(_I32))
            tr["first_round"] = torch.minimum(
                tr["first_round"],
                torch.where(pending_t, rnd, _INT32_MAX).to(_I32))
            tr["retries"] = tr["retries"] + waiting
            tr["mode"] = torch.maximum(tr["mode"], mode_t)
            tr["wait_rounds"] = tr["wait_rounds"] + waiting
            # the head (fast) validates nothing; every other pending txn
            # validates its read set this round
            tr["validation_words"] = tr["validation_words"] + torch.where(
                pending_t & ~is_head_t, res.rn, 0).sum(dtype=_I32)
            tr["exec_ops"] = (
                tr["exec_ops"]
                + torch.where(pending_t, batch.n_ins, 0).sum(dtype=_I32)
                + torch.where(promoted_t, batch.n_ins, 0).sum(dtype=_I32))
            tr["promotions"] = tr["promotions"] + promoted_t.sum(dtype=_I32)
            tr["live_per_round"][rnd] = live.sum(dtype=_I32)
            rs = protocol.commit_round_state(rs, values, versions)
            return rs, n_comm + n_new, rnd + 1

        return round_body

    def cond_at(next_width: int):
        def cond(state):
            _, n_comm, rnd = state
            go = n_comm < n_real and rnd < limit
            if next_width:
                # hand over to the narrower rung once the pending suffix
                # fits it
                go = go and n_real - n_comm > next_width
            return go

        return cond

    rs0 = protocol.init_round_state(batch, store.values.clone(),
                                    store.versions.clone())
    ladder = (protocol.compact_ladder(k) if (incremental and compact)
              else [k])
    rs, n_comm, rnd = protocol.run_compact_cascade(
        ladder, (rs0, 0, 0), round_body_at, cond_at)

    committed = real & (tr["commit_round"] >= 0)
    trace = make_trace(
        k, device=dev,
        commit_round=tr["commit_round"],
        first_round=torch.where(real, tr["first_round"], -1).to(_I32),
        retries=tr["retries"], mode=tr["mode"],
        wait_rounds=tr["wait_rounds"],
        rounds=torch.tensor(rnd, dtype=_I32, device=dev),
        validation_words=tr["validation_words"], exec_ops=tr["exec_ops"],
        promotions=tr["promotions"],
        live_txns=rs.live_txns, live_slots=rs.live_slots,
        walked_slots=rs.walked_slots,
        live_per_round=tr["live_per_round"],
        # PCC commits in sequence order: position = rank in the order.
        # Vacant rows and rows a max_rounds cap left uncommitted are not
        # part of the history
        commit_pos=torch.where(committed, rank, -1).to(_I32))
    gv = torch.tensor(gv0 + n_comm, dtype=_I32, device=dev)
    return store_with(store, rs.values, rs.versions, gv), trace


pcc_execute = _pcc_execute


def _pcc_raw(store, batch, seq, lanes, n_lanes):
    del lanes, n_lanes  # PCC has no lane structure
    return _pcc_execute(store, batch, seq)


register_engine(EngineDef(
    "pcc", _pcc_raw,
    doc="Pot Concurrency Control — ordered prefix commit + live promotion"))
