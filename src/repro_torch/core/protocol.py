"""Shared pieces of the round protocol (serial part, dense store), after
``repro.core.protocol``.

**Round state.**  :class:`RoundState` is what an engine carries from one
round to the next: the committed image, the cached per-transaction
results (only the *live* rows re-execute, :func:`refresh_round_state`)
and, in the matrix formulation, the K×K conflict table with the packed
footprints behind it, of which only live rows and columns are
recomputed.  Decisions consume only rows of pending transactions, and
every pending transaction is live, so the incremental loop decides
exactly as a from-scratch rebuild.

**Gather-compacted rounds.**  Once the live set fits a narrower rung of
:func:`compact_ladder`, the read phase gathers the live rows into a
(C, L) block, executes that, and scatters the results back, with the
table's refreshed row and column strips computed by the pair kernel
(:func:`refresh_round_state_gathered`).

**Commit pipeline.**  Conflict analysis (:func:`earlier_writer_conflicts`
over the carried table, or the scatter-min formulation), the maximal
in-order prefix (:func:`prefix_commit`, a cumulative AND) and one fused
write-back (:func:`fused_write_back`, winner per address by
(rank, slot) segment-max).

Formulation.  On CUDA tensors the engines take the matrix formulation
(``kernel_ops._on_cuda``), so that the hand-written delta kernel carries
the full rung and the pair kernel the compact rungs.  On CPU tensors
they take the reference's off-TPU path: scatter-min, no packed bitsets.
The two give the same decisions.

The reference's ``lax.while_loop`` rounds are a host loop here; the
round-state counters stay on the device as int32 tensors.  Write-backs
install into the image they are given, in place: the engine copies the
store image once per batch and owns that copy.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.txn import (TxnBatch, TxnResult, gather_live_indices,
                                  next_pow2, run_compact, run_live,
                                  scatter_result, scatter_rows)
from repro_torch.kernels import ops as kernel_ops

_I32 = torch.int32


def dedup_last_writer(waddrs: torch.Tensor, wn) -> torch.Tensor:
    """Mask selecting, per address, only the LAST of a transaction's (L,)
    write-set entries (a later deferred write to the same object wins).
    Sort-based: order the slots by address (stable) and keep a slot iff
    it is valid and the next slot in sorted order holds another
    address."""
    length = waddrs.shape[0]
    idx = torch.arange(length, device=waddrs.device)
    valid = idx < wn
    # invalid slots sort behind every real address (object ids are far
    # below int32 max)
    key = torch.where(valid, waddrs, torch.iinfo(torch.int32).max)
    order = torch.argsort(key, stable=True)
    sorted_key = key[order]
    nxt = torch.cat([sorted_key[1:], sorted_key.new_full((1,), -1)])
    keep = torch.zeros((length,), dtype=torch.bool, device=waddrs.device)
    keep[order] = sorted_key != nxt
    return valid & keep


def apply_writes(values, versions, waddrs, wvals, wn, seq_no):
    """Write back one committing transaction, in place: install its
    deferred values (last write per address) and stamp the objects'
    versions with its sequence number."""
    keep = dedup_last_writer(waddrs, wn)
    tgt = waddrs[keep].long()
    values[tgt] = wvals[keep]
    versions[tgt] = seq_no
    return values, versions


# --------------------------------------------------------------------------
# Conflict formulation
# --------------------------------------------------------------------------


def _matrix_backend(t: torch.Tensor) -> bool:
    # one dispatch predicate shared with the kernel wrappers
    return kernel_ops._on_cuda(t)


def conflict_table(res: TxnResult, n_objects: int) -> torch.Tensor | None:
    """The round's K×K footprint-vs-write-set table in txn space (entry
    (i, j) = footprint(i) ∩ writes(j) ≠ ∅) where the matrix formulation
    is in use (CUDA); None elsewhere (scatter-min, same verdicts)."""
    if not _matrix_backend(res.raddrs):
        return None
    return kernel_ops.conflict_matrix(res.raddrs, res.rn, res.waddrs,
                                      res.wn, n_objects)


# --------------------------------------------------------------------------
# Incremental round state
# --------------------------------------------------------------------------


@dataclasses.dataclass
class RoundState:
    """Per-batch execution state carried across an engine's rounds.

    ``conflict`` / ``foot_bits`` / ``write_bits`` are carried only in the
    matrix formulation (CUDA), where the kernels compute the table; they
    are None under the scatter-min formulation."""

    values: torch.Tensor        # (O, S) committed store image
    versions: torch.Tensor      # (O,)
    res: TxnResult              # cached speculative executions (K rows)
    conflict: torch.Tensor | None    # (K, K) bool carried table
    foot_bits: torch.Tensor | None   # (K, W) int32 packed footprints
    write_bits: torch.Tensor | None  # (K, W) int32 packed write sets
    live: torch.Tensor          # (K,) bool — rows refreshed this round
    live_txns: torch.Tensor     # () int32 — Σ rounds live count
    live_slots: torch.Tensor    # () int32 — Σ rounds live instruction slots
    walked_slots: torch.Tensor  # () int32 — Σ rounds executor width × L


def init_round_state(batch: TxnBatch, values: torch.Tensor,
                     versions: torch.Tensor) -> RoundState:
    """A fresh RoundState with empty caches.  The table and the packed
    bitsets are allocated only in the matrix formulation (CUDA, as
    :func:`conflict_table` decides).  Every row must be refreshed no
    later than the first round that consumes it."""
    k, length = batch.opcodes.shape
    slot = values.shape[-1]
    dev = values.device
    z = lambda shape, dtype=_I32: torch.zeros(shape, dtype=dtype, device=dev)
    res = TxnResult(raddrs=z((k, length)), rn=z((k,)),
                    waddrs=z((k, length)), wvals=z((k, length, slot)),
                    wn=z((k,)))
    conflict = foot_bits = write_bits = None
    if _matrix_backend(values):
        w = -(-values.shape[0] // 32)
        conflict = z((k, k), torch.bool)
        foot_bits = z((k, w))
        write_bits = z((k, w))
    return RoundState(
        values=values, versions=versions, res=res, conflict=conflict,
        foot_bits=foot_bits, write_bits=write_bits,
        live=z((k,), torch.bool), live_txns=z(()), live_slots=z(()),
        walked_slots=z(()))


def refresh_round_state(state: RoundState, batch: TxnBatch,
                        live: torch.Tensor) -> RoundState:
    """One round's read phase at the full rung: re-execute the live rows
    against the current image and delta-update the carried table (the
    delta kernel).  Live rows of ``res`` equal a from-scratch
    ``run_all``; table entries with a live row or column equal the
    from-scratch table; everything else is carried."""
    n_obj = state.values.shape[0]
    res = run_live(batch, state.values, live, state.res, n_objects=n_obj)
    conflict, foot_bits, write_bits = (
        state.conflict, state.foot_bits, state.write_bits)
    if conflict is not None:   # packed bitsets + delta kernel
        foot_bits, write_bits = kernel_ops.update_packed_footprints(
            foot_bits, write_bits, res.raddrs, res.rn, res.waddrs, res.wn,
            live, n_obj)
        conflict = kernel_ops.conflict_matrix_delta(
            foot_bits, write_bits, conflict, live)
    k, length = batch.opcodes.shape
    return RoundState(
        values=state.values, versions=state.versions, res=res,
        conflict=conflict, foot_bits=foot_bits, write_bits=write_bits,
        live=live,
        live_txns=state.live_txns + live.sum(dtype=_I32),
        live_slots=state.live_slots
        + torch.where(live, batch.n_ins, 0).sum(dtype=_I32),
        walked_slots=state.walked_slots + k * length)


def commit_round_state(state: RoundState, values: torch.Tensor,
                       versions: torch.Tensor) -> RoundState:
    """Fold a round's committed store image back into the carried state."""
    return dataclasses.replace(state, values=values, versions=versions)


# --------------------------------------------------------------------------
# Gather-compacted rounds
# --------------------------------------------------------------------------


def compact_ladder(k: int, min_width: int = 8, step: int = 4) -> list[int]:
    """The descending widths a round cascade runs at: ``[k, p/step,
    p/step², ...]`` with ``p = next_pow2(k)``, stopping above
    ``min_width``.  Rung 0 is the full masked width; a later rung is
    entered once the live count fits it."""
    widths = [k]
    c = next_pow2(k) // step
    while c >= min_width and c < k:
        widths.append(c)
        c //= step
    return widths


def run_compact_cascade(ladder: list[int], state, body_at, cond_at):
    """Drive an engine's round loop down the compact ladder: at each rung
    run ``body_at(width)`` while ``cond_at(next_width)`` holds
    (``next_width`` is 0 on the last rung: run to completion)."""
    for i, width in enumerate(ladder):
        nxt = ladder[i + 1] if i + 1 < len(ladder) else 0
        body, cond = body_at(width), cond_at(nxt)
        while cond(state):
            state = body(state)
    return state


def refresh_round_state_gathered(state: RoundState, batch: TxnBatch,
                                 idx: torch.Tensor, valid: torch.Tensor
                                 ) -> tuple[RoundState, TxnResult]:
    """One round's read phase over a gathered compact block: execute rows
    ``batch[idx]`` at width C = ``idx.shape[0]`` (``valid`` masks gather
    padding) and scatter the results, the packed-footprint rows and the
    table's refreshed row and column strips (the pair kernel) back to
    full-K positions.  Returns ``(state, cres)``."""
    k, length = batch.opcodes.shape
    width = idx.shape[0]
    n_obj = state.values.shape[0]
    cres = run_compact(batch, state.values, idx, valid, n_objects=n_obj)
    res = scatter_result(state.res, cres, idx, valid)
    live = scatter_rows(torch.zeros((k,), dtype=torch.bool,
                                    device=valid.device), valid, idx, valid)
    conflict, foot_bits, write_bits = (
        state.conflict, state.foot_bits, state.write_bits)
    if conflict is not None:   # packed strips + pair kernel
        foot_bits, write_bits = kernel_ops.update_packed_footprints_compact(
            foot_bits, write_bits, cres.raddrs, cres.rn, cres.waddrs,
            cres.wn, idx, valid, n_obj)
        conflict = kernel_ops.conflict_matrix_delta_compact(
            foot_bits, write_bits, conflict, idx, valid)
    return RoundState(
        values=state.values, versions=state.versions, res=res,
        conflict=conflict, foot_bits=foot_bits, write_bits=write_bits,
        live=live,
        live_txns=state.live_txns + valid.sum(dtype=_I32),
        live_slots=state.live_slots
        + torch.where(valid, batch.n_ins[idx], 0).sum(dtype=_I32),
        walked_slots=state.walked_slots + width * length), cres


def refresh_round_state_compact(state: RoundState, batch: TxnBatch,
                                live: torch.Tensor, width: int
                                ) -> tuple[RoundState, TxnResult,
                                           torch.Tensor, torch.Tensor]:
    """One round's read phase at compact width ``width``: gather the live
    rows (ascending) and refresh through
    :func:`refresh_round_state_gathered`.  Requires
    ``live.sum() <= width``.  Returns ``(state, cres, idx, valid)``."""
    idx, valid = gather_live_indices(live, width)
    state, cres = refresh_round_state_gathered(state, batch, idx, valid)
    return state, cres, idx, valid


# --------------------------------------------------------------------------
# Commit decisions and write-back
# --------------------------------------------------------------------------


def earlier_writer_conflicts(res: TxnResult, conflict: torch.Tensor | None,
                             writer_mask: torch.Tensor, rank: torch.Tensor,
                             n_objects: int) -> torch.Tensor:
    """bad (K,) bool, txn space: does txn t's footprint (reads ∪ writes)
    hit the write set of a txn q with ``writer_mask[q]`` and
    ``rank[q] < rank[t]``?

    * matrix path (``conflict`` given): a masked row-reduction of the
      carried K×K table;
    * scatter path (``conflict`` is None): the first marked writer per
      address by one scatter-min (``amin``, whose result does not depend
      on the order of duplicates) and a footprint gather:
      ∃ marked q earlier writing a  ⟺  first_writer[a] < rank[t].
    """
    if conflict is not None:
        earlier = writer_mask[None, :] & (rank[None, :] < rank[:, None])
        return (conflict & earlier).any(dim=1)
    k, length = res.waddrs.shape
    slot = torch.arange(length, device=rank.device)
    rank = rank.long()
    wvalid = (slot[None, :] < res.wn[:, None]) & writer_mask[:, None]
    first_writer = torch.full((n_objects + 1,), k, dtype=torch.int64,
                              device=rank.device)
    first_writer.scatter_reduce_(
        0, torch.where(wvalid, res.waddrs.long(), n_objects).reshape(-1),
        torch.where(wvalid, rank[:, None], k).reshape(-1), "amin",
        include_self=True)

    def hit(addrs, n):
        valid = slot[None, :] < n[:, None]
        first = first_writer[torch.where(valid, addrs.long(), n_objects)]
        return (first < rank[:, None]).any(dim=1)

    return hit(res.raddrs, res.rn) | hit(res.waddrs, res.wn)


def prefix_commit(res: TxnResult, conflict: torch.Tensor | None,
                  order: torch.Tensor, rank: torch.Tensor, n_comm: int,
                  n_objects: int,
                  real: torch.Tensor | None = None) -> torch.Tensor:
    """Maximal committing in-order prefix (PCC's ordered commit, §2.2.2):
    a pending position commits iff no pending position up to and
    including it conflicts with an earlier pending transaction — one
    batched conflict query and a cumulative AND (``cummin`` over the 0/1
    prefix).  ``n_comm`` counts already-committed positions; ``real``
    masks out vacant rows.  Returns committing (K,) bool in txn space."""
    k = rank.shape[0]
    pending = rank >= n_comm
    if real is not None:
        pending = pending & real
    bad = earlier_writer_conflicts(res, conflict, pending, rank, n_objects)
    pos = torch.arange(k, device=rank.device)
    ok_pos = torch.where(pos >= n_comm, ~bad[order], True)
    alive_pos = torch.cummin(ok_pos.to(_I32), dim=0).values.bool()
    return pending & alive_pos[rank]


def fused_write_back(values, versions, waddrs, wvals, wn, committing, rank,
                     seq_nos):
    """Install a whole round of commits in one scatter, in place.  The
    winning writer per address has the largest (rank, slot) priority:
    later committers overwrite earlier ones and, within a transaction,
    the later deferred write wins.  Priorities are unique, so exactly
    one slot per address is scattered."""
    return _shard_write_back(values, versions, 0, waddrs, wvals, wn,
                             committing, rank, seq_nos, values.shape[0])


def _shard_write_back(values_s, versions_s, shard, waddrs, wvals, wn,
                      committing, rank, seq_nos, shard_size: int):
    """One shard's slice of :func:`fused_write_back`: the (rank, slot)
    segment-max (``amax``) winner selection over the write slots whose
    address falls in this shard, at shard-local offsets.  The dense store
    is the call with ``shard=0, shard_size=O``."""
    c = values_s.shape[0]
    k, length = waddrs.shape
    slot = torch.arange(length, device=waddrs.device)
    valid = (committing[:, None] & (slot[None, :] < wn[:, None])
             & (waddrs // shard_size == shard))
    prio = rank.long()[:, None] * length + slot[None, :]
    addr = torch.where(valid, (waddrs % shard_size).long(), c).reshape(-1)
    flat_prio = torch.where(valid, prio, -1).reshape(-1)
    best = torch.full((c + 1,), -1, dtype=torch.int64, device=waddrs.device)
    best.scatter_reduce_(0, addr, flat_prio, "amax", include_self=True)
    win = valid.reshape(-1) & (flat_prio == best[addr])
    tgt = addr[win]
    values_s[tgt] = wvals.reshape(k * length, -1)[win]
    versions_s[tgt] = seq_nos.to(_I32).repeat_interleave(length)[win]
    return values_s, versions_s
