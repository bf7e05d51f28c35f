"""The scan-based commit machinery, frozen, after
``repro.core.legacy_scan``.

These are the sequential implementations the vectorized commit pipeline
(``protocol.conflict_table`` / ``prefix_commit`` / ``wave_commit`` /
``fused_write_back``) replaced: every round walks all K transactions one
position at a time, with a bitmap probe over the (O,) written set and a
write-back per transaction.  They are kept, unregistered, as the oracle
the engines are held to: their store image and trace equal every
engine's, field for field (``tests/test_torch_legacy_scan.py``).

The reference's ``lax.scan`` over positions is a host loop over
positions here, and each ``lax.cond`` a host branch on the device bool
it tests (one read-back a position); the sequence order (``seq``,
``arrival``) and DeSTM's ``lanes`` are inputs, read to the host once.
The trace's ``.at[order]`` updates become gathers through the inverse
permutation, since ``order`` is a permutation.  Version stamps are
gv-rebased as in the reference: ``gv0 + p + 1`` for the transaction at
sequence position p (PCC, DeSTM), ``gv0 + commit index + 1`` (OCC).

Do not "fix" or optimize this module: its value is being frozen.
"""

from __future__ import annotations

import torch

from repro_torch.core import protocol
from repro_torch.core.engine import (MODE_FAST, MODE_PREFIX, MODE_SPEC,
                                     MODE_UNSET, ExecTrace, make_trace,
                                     rank_from_order, seq_rank)
from repro_torch.core.tstore import TStore
from repro_torch.core.txn import TxnBatch, run_all, run_txn

_I32 = torch.int32
_INT32_MAX = torch.iinfo(torch.int32).max


def _i32(x, dev) -> torch.Tensor:
    return torch.tensor(x, dtype=_I32, device=dev)


def _probe(written, res, t) -> bool:
    """Does transaction ``t``'s footprint overlap ``written``?"""
    return bool(protocol.footprint_conflicts(
        written, res.raddrs[t], res.rn[t], res.waddrs[t], res.wn[t]))


def pcc_execute_scan(store: TStore, batch: TxnBatch, seq: torch.Tensor,
                     max_rounds: int | None = None,
                     live_promotion: bool = True
                     ) -> tuple[TStore, ExecTrace]:
    """Scan-based PCC round: per-txn validation probe + per-txn
    write-back, then live promotion of the new order head."""
    k = batch.n_txns
    dev = store.device
    order_t = torch.argsort(seq, stable=True)  # order[p] = txn at position p
    order = order_t.tolist()
    rank = rank_from_order(order_t)            # position -> txn space: [rank]
    gv0 = int(store.gv)
    values, versions = store.values.clone(), store.versions.clone()
    pos = torch.arange(k, device=dev)
    n_ins_pos = batch.n_ins[order_t]
    limit = max_rounds if max_rounds is not None else k + 1

    full = lambda v: torch.full((k,), v, dtype=_I32, device=dev)
    tr = dict(commit_round=full(-1), first_round=full(_INT32_MAX),
              retries=full(0), mode=full(0), wait_rounds=full(0),
              validation_words=_i32(0, dev), exec_ops=_i32(0, dev),
              promotions=_i32(0, dev))
    gv, n_comm, rnd = gv0, 0, 0
    while n_comm < k and rnd < limit:
        res = run_all(batch, values)

        # --- ordered commit: maximal non-conflicting in-order prefix -----
        written = torch.zeros((store.n_objects,), dtype=torch.bool,
                              device=dev)
        alive = True
        committing = [False] * k
        for p in range(k):
            t = order[p]
            pending = p >= n_comm
            if alive and pending and not _probe(written, res, t):
                protocol.mark_writes(written, res.waddrs[t], res.wn[t])
                committing[p] = True
            alive = alive and (committing[p] or not pending)

        # --- write-back in sequence order --------------------------------
        for p in range(k):
            if committing[p]:
                t = order[p]
                protocol.apply_writes(values, versions, res.waddrs[t],
                                      res.wvals[t], res.wn[t], gv0 + p + 1)
        n_new = sum(committing)
        gv += n_new

        # ---- live promotion (paper §2.2.3)
        promoted_pos = -1
        head_pos = n_comm + n_new
        if live_promotion and head_pos < k:
            t = order[head_pos]
            _, _, waddrs2, wvals2, wn2 = run_txn(batch.rows(t), values)
            protocol.apply_writes(values, versions, waddrs2, wvals2, wn2,
                                  gv0 + head_pos + 1)
            gv += 1
            promoted_pos = head_pos
            n_new += 1

        # --- trace bookkeeping (by txn index) ----------------------------
        committing_pos = torch.tensor(committing, device=dev)
        pending_pos = pos >= n_comm
        is_head = pos == n_comm
        promoted_mask = pos == promoted_pos
        committing_all = committing_pos | promoted_mask
        waiting = pending_pos & ~committing_all
        mode_pos = torch.where(
            committing_all,
            torch.where(is_head | promoted_mask, MODE_FAST, MODE_PREFIX),
            torch.where(pending_pos, MODE_SPEC, MODE_UNSET)).to(_I32)
        by_txn = lambda a: a[rank]
        tr["commit_round"] = torch.maximum(tr["commit_round"], by_txn(
            torch.where(committing_all, rnd, -1).to(_I32)))
        tr["first_round"] = torch.minimum(tr["first_round"], by_txn(
            torch.where(pending_pos, rnd, _INT32_MAX).to(_I32)))
        tr["retries"] = tr["retries"] + by_txn(waiting.to(_I32))
        tr["mode"] = torch.maximum(tr["mode"], by_txn(mode_pos))
        tr["wait_rounds"] = tr["wait_rounds"] + by_txn(waiting.to(_I32))
        rn_pos = res.rn[order_t]
        tr["validation_words"] = tr["validation_words"] + torch.where(
            pending_pos & ~is_head, rn_pos, 0).sum(dtype=_I32)
        tr["exec_ops"] = (
            tr["exec_ops"]
            + torch.where(pending_pos, n_ins_pos, 0).sum(dtype=_I32)
            + torch.where(promoted_mask, n_ins_pos, 0).sum(dtype=_I32))
        tr["promotions"] = tr["promotions"] + promoted_mask.sum(dtype=_I32)
        n_comm += n_new
        rnd += 1

    trace = make_trace(k, device=dev, rounds=_i32(rnd, dev),
                       commit_pos=seq_rank(seq).to(_I32), **tr)
    return TStore(values=values, versions=versions, gv=_i32(gv, dev)), trace


def occ_execute_scan(store: TStore, batch: TxnBatch, arrival: torch.Tensor,
                     max_waves: int | None = None
                     ) -> tuple[TStore, ExecTrace]:
    """Scan-based OCC wave: per-txn probe, arrival order, no prefix rule.

    Version stamps are gv-rebased (gv0 + commit position + 1, matching
    ``repro_torch.core.occ``) so they stay globally monotone across
    batches."""
    k = batch.n_txns
    dev = store.device
    arr = arrival.tolist()
    arr_rank = rank_from_order(arrival.long())   # arrival position -> txn
    gv0 = int(store.gv)
    values, versions = store.values.clone(), store.versions.clone()
    limit = max_waves if max_waves is not None else k + 1

    tr = dict(commit_pos=torch.full((k,), -1, dtype=_I32, device=dev),
              retries=torch.zeros((k,), dtype=_I32, device=dev),
              exec_ops=_i32(0, dev))
    done = [False] * k
    n_comm, wave = 0, 0
    while not all(done) and wave < limit:
        res = run_all(batch, values)

        written = torch.zeros((store.n_objects,), dtype=torch.bool,
                              device=dev)
        committing = [False] * k
        for p in range(k):
            t = arr[p]
            if not done[t] and not _probe(written, res, t):  # no prefix rule
                protocol.mark_writes(written, res.waddrs[t], res.wn[t])
                committing[p] = True

        commit_idx, c = [], n_comm
        for p in range(k):
            c += committing[p]
            commit_idx.append(c - 1)
        for p in range(k):
            if committing[p]:
                t = arr[p]
                protocol.apply_writes(values, versions, res.waddrs[t],
                                      res.wvals[t], res.wn[t],
                                      gv0 + commit_idx[p] + 1)

        committing_pos = torch.tensor(committing, device=dev)
        pending_t = ~torch.tensor(done, device=dev)
        committed_t = committing_pos[arr_rank]
        tr["commit_pos"] = torch.maximum(tr["commit_pos"], torch.where(
            committing_pos, _i32(commit_idx, dev), -1)[arr_rank].to(_I32))
        tr["retries"] = tr["retries"] + (pending_t & ~committed_t).to(_I32)
        tr["exec_ops"] = tr["exec_ops"] + torch.where(
            pending_t, batch.n_ins, 0).sum(dtype=_I32)
        for p in range(k):
            done[arr[p]] = done[arr[p]] or committing[p]
        n_comm += sum(committing)
        wave += 1

    trace = make_trace(k, device=dev, commit_pos=tr["commit_pos"],
                       retries=tr["retries"], rounds=_i32(wave, dev),
                       exec_ops=tr["exec_ops"], commit_round=tr["retries"])
    return TStore(values=values, versions=versions,
                  gv=_i32(gv0 + n_comm, dev)), trace


def destm_execute_scan(store: TStore, batch: TxnBatch, seq: torch.Tensor,
                       lanes: torch.Tensor, n_lanes: int,
                       max_rounds: int | None = None
                       ) -> tuple[TStore, ExecTrace]:
    """Scan-based DeSTM round: per-lane pick scan + token-order commit
    scan, a conflicting pick re-executed against the image so far."""
    k = batch.n_txns
    dev = store.device
    order_t = torch.argsort(seq, stable=True)
    order = order_t.tolist()
    rank = rank_from_order(order_t)
    lane_of = lanes.tolist()
    n_ins = batch.n_ins.tolist()
    gv0 = int(store.gv)
    values, versions = store.values.clone(), store.versions.clone()
    limit = max_rounds if max_rounds is not None else k + 1

    retries = [0] * k
    exec_ops = 0
    commit_round = torch.full((k,), -1, dtype=_I32, device=dev)
    barrier_ops = _i32(0, dev)
    done = [False] * k
    rnd = 0
    while not all(done) and rnd < limit:
        # one transaction per lane: the first undone one in token order
        taken = [False] * n_lanes
        selected = [False] * k
        for p in range(k):
            t = order[p]
            lane = lane_of[t]
            selected[p] = not done[t] and not taken[lane]
            taken[lane] = taken[lane] or selected[p]

        res = run_all(batch, values)
        written = torch.zeros((store.n_objects,), dtype=torch.bool,
                              device=dev)
        for p in range(k):
            if not selected[p]:
                continue
            t = order[p]
            if _probe(written, res, t):
                # retry: re-execute against the image committed so far
                _, _, waddrs, wvals, wn = run_txn(batch.rows(t), values)
                retries[t] += 1
                exec_ops += 2 * n_ins[t]
            else:
                waddrs, wvals, wn = res.waddrs[t], res.wvals[t], res.wn[t]
                exec_ops += n_ins[t]
            protocol.apply_writes(values, versions, waddrs, wvals, wn,
                                  gv0 + p + 1)
            protocol.mark_writes(written, waddrs, wn)

        sel_t = torch.tensor(selected, device=dev)[rank]
        cost = torch.where(sel_t, batch.n_ins, 0)
        n_sel = sel_t.sum(dtype=_I32)
        if int(n_sel) > 0:
            barrier_ops = barrier_ops + (
                n_sel * cost.max() - cost.sum(dtype=_I32)).to(_I32)
        for p in range(k):
            done[order[p]] = done[order[p]] or selected[p]
        commit_round = torch.where(sel_t, rnd, commit_round).to(_I32)
        rnd += 1

    commit_pos = seq_rank(commit_round.long() * (k + 1) + seq_rank(seq))
    trace = make_trace(
        k, device=dev, commit_round=commit_round,
        retries=_i32(retries, dev), rounds=_i32(rnd, dev),
        exec_ops=_i32(exec_ops, dev), barrier_ops=barrier_ops,
        first_round=commit_round, commit_pos=commit_pos.to(_I32))
    return TStore(values=values, versions=versions,
                  gv=_i32(gv0 + k, dev)), trace
