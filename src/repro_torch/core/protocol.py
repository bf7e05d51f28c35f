"""Shared pieces of the round protocol, after ``repro.core.protocol``.

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
in-order prefix (:func:`prefix_commit`, a cumulative AND) or OCC's
greedy arrival-order wave (:func:`wave_commit`, a blocked fixpoint), and
one fused write-back (:func:`fused_write_back`, winner per address by
(rank, slot) segment-max).  DeSTM's retry waves ask their conflict
questions across two result blocks (:func:`cross_writer_conflicts`,
the pair kernel's rectangular strips).

**Cross-batch speculation.**  A pipelined session runs a batch's round 0
against an earlier store (:func:`spec_execute`, a :class:`SpecSeed`);
when the batch's turn comes, :func:`seed_round_state` re-executes only
the rows whose read set was written since (``versions > snap_gv``), and
the engine's round 0 charges its ordinary accounting
(:func:`charge_round_state`) instead of re-walking the batch.

**Shard-partitioned stores.**  Every function takes the store's
:class:`~repro_torch.core.tstore.StoreLayout`.  Under a sharded layout
execution reads the flat view of the stacked shards, the conflict
analysis decomposes per shard into (S, K, ceil(C/32)) packed words
whose per-shard tables OR into the carried K×K table (the ``*_sharded``
twins in ``kernel_ops``), and :func:`fused_write_back` splits into S
independent scatters.  Under a mesh (one shard per rank) a rank packs,
analyses and writes back only its own shard, the tables' OR crosses
ranks, and execution loads rows through ``tstore.MeshRows``.
Conflict(t, u) is the OR over shards of per-shard conflicts and every
decision stays in rank space, so S changes where the work happens,
never a decision.

**Written-set helpers.**  :func:`footprint_conflicts` and
:func:`mark_writes` test and grow an (O,) bool set of written objects:
the validation step of the serial token walk, for many rows at once.

Formulation.  On CUDA tensors the engines take the matrix formulation
(``kernel_ops._on_cuda``), so that the hand-written delta kernel carries
the full rung and the pair kernel the compact rungs.  On CPU tensors
they take the reference's off-TPU path: scatter-min, no packed bitsets,
except under a sharded layout, which takes the matrix formulation on
the CPU too (through the kernels' plain versions), as the reference
does.  The two formulations give the same decisions.

The reference's ``lax.while_loop`` rounds are a host loop here; the
round-state counters stay on the device as int32 tensors.  Write-backs
install into the image they are given, in place: the engine copies the
store image once per batch and owns that copy.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.tstore import StoreLayout, flat_values
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


def apply_writes(values, versions, waddrs, wvals, wn, seq_no,
                 layout: StoreLayout | None = None):
    """Write back one committing transaction, in place: install its
    deferred values (last write per address) and stamp the objects'
    versions with its sequence number.  Under a sharded ``layout``
    address a lands in shard a // C at offset a % C: the same values and
    winners as the dense scatter (a transaction's deduplicated writes hit
    distinct addresses); under a mesh each rank installs the writes to
    its own shard."""
    keep = dedup_last_writer(waddrs, wn)
    if layout is not None and layout.mesh is not None:
        # one shard per rank: install only the writes this rank owns,
        # into its one stacked shard
        keep = keep & (layout.shard_of(waddrs) == layout.rank)
        tgt = waddrs[keep].long()
        tgt = (torch.zeros_like(tgt), layout.offset_of(tgt))
    elif layout is not None and layout.sharded:
        tgt = waddrs[keep].long()
        tgt = (layout.shard_of(tgt), layout.offset_of(tgt))
    else:
        tgt = waddrs[keep].long()
    values[tgt] = wvals[keep]
    versions[tgt] = seq_no
    return values, versions


def footprint_conflicts(written: torch.Tensor, raddrs, rn, waddrs, wn
                        ) -> torch.Tensor:
    """Does each row's footprint overlap ``written`` (O,) bool?  The
    validation step (paper Fig. 2b line 9) for rows of (..., L)
    addresses with (...,) valid counts; returns (...,) bool."""
    slot = torch.arange(raddrs.shape[-1], device=raddrs.device)

    def hit(addrs, n):
        valid = slot < n[..., None]
        return (written[torch.where(valid, addrs, 0).long()] & valid).any(-1)

    return hit(raddrs, rn) | hit(waddrs, wn)


def mark_writes(written: torch.Tensor, waddrs, wn) -> torch.Tensor:
    """written |= the write sets of rows of (..., L) addresses with
    (...,) valid counts, in place.  A masked max-scatter: every value
    written is True and invalid slots add nothing, so duplicate
    addresses leave no choice of winner and no sentinel is written."""
    slot = torch.arange(waddrs.shape[-1], device=waddrs.device)
    valid = slot < wn[..., None]
    written.view(torch.uint8).scatter_reduce_(
        0, torch.where(valid, waddrs, 0).reshape(-1).long(),
        valid.reshape(-1).to(torch.uint8), "amax")
    return written


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
    matrix formulation (CUDA, or any sharded store), where the kernels
    compute the table; they are None under the scatter-min
    formulation."""

    values: torch.Tensor        # (O, S) committed store image
    versions: torch.Tensor      # (O,)
    res: TxnResult              # cached speculative executions (K rows)
    conflict: torch.Tensor | None    # (K, K) bool carried table
    foot_bits: torch.Tensor | None   # (K, W) or (S, K, W_s) int32 packed
    write_bits: torch.Tensor | None  # footprints and write sets
    live: torch.Tensor          # (K,) bool — rows refreshed this round
    live_txns: torch.Tensor     # () int32 — Σ rounds live count
    live_slots: torch.Tensor    # () int32 — Σ rounds live instruction slots
    walked_slots: torch.Tensor  # () int32 — Σ rounds executor width × L


def init_round_state(batch: TxnBatch, values: torch.Tensor,
                     versions: torch.Tensor, *,
                     track_conflict: bool = True,
                     layout: StoreLayout | None = None) -> RoundState:
    """A fresh RoundState with empty caches.  The table and the packed
    bitsets are allocated only in the matrix formulation (CUDA, as
    :func:`conflict_table` decides, or any sharded ``layout``), and never
    with ``track_conflict=False`` (DeSTM, which asks its conflict
    questions on a compact per-round block).  Every row must be refreshed
    no later than the first round that consumes it.

    A sharded store takes the matrix formulation on the CPU too (the
    kernels' plain versions): ``foot_bits`` / ``write_bits`` are
    (S, K, W_s) words, each shard's bitset spanning its own range, and
    ``conflict`` the OR-reduced K×K table the decisions consume (under a
    mesh (1, K, W_s), the rank's own shard)."""
    sharded = layout is not None and layout.sharded
    k, length = batch.opcodes.shape
    slot = values.shape[-1]
    dev = values.device
    z = lambda shape, dtype=_I32: torch.zeros(shape, dtype=dtype, device=dev)
    res = TxnResult(raddrs=z((k, length)), rn=z((k,)),
                    waddrs=z((k, length)), wvals=z((k, length, slot)),
                    wn=z((k,)))
    conflict = foot_bits = write_bits = None
    if track_conflict and (sharded or _matrix_backend(values)):
        if sharded:
            shape = (layout.held_shards, k, layout.words_per_shard)
        else:
            shape = (k, -(-values.shape[0] // 32))
        conflict = z((k, k), torch.bool)
        foot_bits = z(shape)
        write_bits = z(shape)
    return RoundState(
        values=values, versions=versions, res=res, conflict=conflict,
        foot_bits=foot_bits, write_bits=write_bits,
        live=z((k,), torch.bool), live_txns=z(()), live_slots=z(()),
        walked_slots=z(()))


def _n_objects(values: torch.Tensor, layout: StoreLayout | None) -> int:
    return layout.n_objects if layout is not None else values.shape[0]


def refresh_round_state(state: RoundState, batch: TxnBatch,
                        live: torch.Tensor,
                        layout: StoreLayout | None = None) -> RoundState:
    """One round's read phase at the full rung: re-execute the live rows
    against the current image and delta-update the carried table (the
    delta kernel).  Live rows of ``res`` equal a from-scratch
    ``run_all``; table entries with a live row or column equal the
    from-scratch table; everything else is carried.  Under a sharded
    ``layout`` execution reads the flat view of the shards and the delta
    runs once per shard, OR-reduced."""
    n_obj = _n_objects(state.values, layout)
    res = run_live(batch, flat_values(state.values, layout), live,
                   state.res, n_objects=n_obj)
    conflict, foot_bits, write_bits = (
        state.conflict, state.foot_bits, state.write_bits)
    if conflict is not None and layout is not None and layout.sharded:
        foot_bits, write_bits = kernel_ops.update_packed_footprints_sharded(
            foot_bits, write_bits, res.raddrs, res.rn, res.waddrs, res.wn,
            live, layout)
        conflict = kernel_ops.conflict_matrix_delta_sharded(
            foot_bits, write_bits, conflict, live, layout)
    elif conflict is not None:   # packed bitsets + delta kernel
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
                                 idx: torch.Tensor, valid: torch.Tensor,
                                 layout: StoreLayout | None = None
                                 ) -> tuple[RoundState, TxnResult]:
    """One round's read phase over a gathered compact block: execute rows
    ``batch[idx]`` at width C = ``idx.shape[0]`` (``valid`` masks gather
    padding) and scatter the results, the packed-footprint rows and the
    table's refreshed row and column strips (the pair kernel; once per
    shard under a sharded ``layout``, OR-reduced) back to full-K
    positions.  Returns ``(state, cres)``."""
    k, length = batch.opcodes.shape
    width = idx.shape[0]
    n_obj = _n_objects(state.values, layout)
    cres = run_compact(batch, flat_values(state.values, layout), idx, valid,
                       n_objects=n_obj)
    res = scatter_result(state.res, cres, idx, valid)
    live = scatter_rows(torch.zeros((k,), dtype=torch.bool,
                                    device=valid.device), valid, idx, valid)
    conflict, foot_bits, write_bits = (
        state.conflict, state.foot_bits, state.write_bits)
    if conflict is not None and layout is not None and layout.sharded:
        foot_bits, write_bits = \
            kernel_ops.update_packed_footprints_compact_sharded(
                foot_bits, write_bits, cres.raddrs, cres.rn, cres.waddrs,
                cres.wn, idx, valid, layout)
        conflict = kernel_ops.conflict_matrix_delta_compact_sharded(
            foot_bits, write_bits, conflict, idx, valid, layout)
    elif conflict is not None:   # packed strips + pair kernel
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
                                live: torch.Tensor, width: int,
                                layout: StoreLayout | None = None
                                ) -> tuple[RoundState, TxnResult,
                                           torch.Tensor, torch.Tensor]:
    """One round's read phase at compact width ``width``: gather the live
    rows (ascending) and refresh through
    :func:`refresh_round_state_gathered`.  Requires
    ``live.sum() <= width``.  Returns ``(state, cres, idx, valid)``."""
    idx, valid = gather_live_indices(live, width)
    state, cres = refresh_round_state_gathered(state, batch, idx, valid,
                                               layout)
    return state, cres, idx, valid


# --------------------------------------------------------------------------
# Cross-batch speculative pipelining
# --------------------------------------------------------------------------
#
# While earlier batches commit, PotSession runs batch n+1's round-0 read
# phase and conflict analysis against the store as it stands at enqueue
# time (spec_execute) and keeps them as a SpecSeed.  At the batch's turn
# the engine re-bases the seed onto the current store (seed_round_state):
# rows whose read set hit an address written after the snapshot
# (versions > snap_gv; version stamps are globally monotone sequence
# numbers) re-execute through one rung of the compact ladder; every other
# row's cached result already equals a fresh round 0, because a row's
# execution is a pure function of the values it reads.  Round 0 then
# charges its ordinary accounting without re-walking the batch, and the
# rest of the run is the serial computation on the same inputs.


@dataclasses.dataclass
class SpecSeed:
    """A speculative round 0 of one batch against an earlier store: the
    cached results and conflict structure a seeded engine re-bases.
    ``conflict`` / ``foot_bits`` / ``write_bits`` are present exactly when
    :class:`RoundState` carries them (the matrix formulation).  A seed
    owns its tensors: nothing the session or an engine writes in place
    aliases them, ``snap_gv`` included."""

    res: TxnResult                    # (K rows) speculative executions
    conflict: torch.Tensor | None     # (K, K) bool speculative table
    foot_bits: torch.Tensor | None    # (K, W) or (S, K, W_s) int32 packed
    write_bits: torch.Tensor | None   # footprints and write sets
    snap_gv: torch.Tensor             # () int32, store.gv at the snapshot


def spec_execute(store, batch: TxnBatch) -> SpecSeed:
    """Run ``batch``'s round-0 read phase and conflict analysis against
    ``store``'s current image (every real row live; the delta kernel in
    the matrix formulation) and capture it as a :class:`SpecSeed`.  The
    store is only read."""
    layout = store.layout
    rs = init_round_state(batch, store.values, store.versions,
                          layout=layout)
    rs = refresh_round_state(rs, batch, batch.n_ins > 0, layout)
    return SpecSeed(res=rs.res, conflict=rs.conflict,
                    foot_bits=rs.foot_bits, write_bits=rs.write_bits,
                    snap_gv=store.gv.clone())


def speculation_invalid(res: TxnResult, versions: torch.Tensor,
                        snap_gv: torch.Tensor,
                        layout: StoreLayout | None = None) -> torch.Tensor:
    """(K,) bool: rows whose logged read set touches an address written
    after the snapshot (``versions > snap_gv``).  Reads alone decide: a
    row's writes are a function of its reads.  Conservative only where a
    logged read-your-writes read hits a dirty address (a needless
    re-execution, never a wrong accept)."""
    if layout is not None and layout.sharded:
        return kernel_ops.spec_read_invalid_sharded(
            res.raddrs, res.rn, versions, snap_gv, layout)
    return kernel_ops.spec_read_invalid(res.raddrs, res.rn, versions,
                                        snap_gv, _n_objects(versions,
                                                            layout))


def seed_round_state(batch: TxnBatch, store, seed: SpecSeed,
                     compact: bool = True
                     ) -> tuple[RoundState, int, int]:
    """Re-base a :class:`SpecSeed` onto ``store``: validate the speculated
    rows, re-execute the invalidated real rows at the narrowest rung of
    :func:`compact_ladder` they fit (the full rung: the delta kernel; a
    compact one: the pair kernel's strips), and return a RoundState whose
    ``res`` and conflict structure equal a fresh round-0 refresh of the
    whole batch against ``store``, with its work counters zeroed so that
    the engine's round 0 charges its ordinary accounting on top.  The
    state owns a copy of the store's image, as the engines' own.

    The reference decides the rung with one ``lax.cond`` per rung; here
    one host read of the invalidated count does (one sync per batch).
    Returns ``(state, n_invalid, spec_rounds)``, the two counts () int32
    tensors, ``spec_rounds`` 1 iff a row re-executed."""
    k = batch.n_txns
    dev = store.device
    layout = store.layout
    z = lambda shape, dtype=_I32: torch.zeros(shape, dtype=dtype, device=dev)
    rs = RoundState(
        values=store.values.clone(), versions=store.versions.clone(),
        res=seed.res, conflict=seed.conflict, foot_bits=seed.foot_bits,
        write_bits=seed.write_bits, live=z((k,), torch.bool),
        live_txns=z(()), live_slots=z(()), walked_slots=z(()))
    invalid = speculation_invalid(seed.res, store.versions, seed.snap_gv,
                                  layout) & (batch.n_ins > 0)
    n_inv = int(invalid.sum())
    if n_inv:
        ladder = compact_ladder(k) if compact else [k]
        nxt = ladder[1:] + [0]
        width = next(w for w, n in zip(ladder, nxt) if n_inv > n)
        if width >= k:
            rs = refresh_round_state(rs, batch, invalid, layout)
        else:
            rs = refresh_round_state_compact(rs, batch, invalid, width,
                                             layout)[0]
        rs = dataclasses.replace(
            rs, live=z((k,), torch.bool), live_txns=z(()),
            live_slots=z(()), walked_slots=z(()))
    count = lambda v: torch.tensor(v, dtype=_I32, device=dev)
    return rs, count(n_inv), count(int(n_inv > 0))


def charge_round_state(state: RoundState, batch: TxnBatch,
                       live: torch.Tensor, width: int) -> RoundState:
    """The accounting of a round-0 refresh at ``width`` without the work:
    set the live mask and charge the counters :func:`refresh_round_state`
    (full rung) or :func:`refresh_round_state_compact` (``live.sum() <=
    width``) would, leaving ``res`` and the conflict structure, which
    :func:`seed_round_state` already made equal to a fresh round 0."""
    length = batch.opcodes.shape[1]
    return dataclasses.replace(
        state, live=live,
        live_txns=state.live_txns + live.sum(dtype=_I32),
        live_slots=state.live_slots
        + torch.where(live, batch.n_ins, 0).sum(dtype=_I32),
        walked_slots=state.walked_slots + width * length)


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


def cross_writer_conflicts(reader_res: TxnResult, writer_res: TxnResult,
                           writer_mask: torch.Tensor, rank: torch.Tensor,
                           n_objects: int,
                           reads_only: bool = False) -> torch.Tensor:
    """bad (C,) bool: does reader row t's footprint (or, with
    ``reads_only``, its logged read set alone) hit the write set of a
    writer row q with ``writer_mask[q]`` and ``rank[q] < rank[t]``?  The
    two-block form of :func:`earlier_writer_conflicts` behind DeSTM's
    retry waves; the verdicts come from the pair kernel's strip
    (``kernel_ops.cross_conflicts``)."""
    mat = kernel_ops.cross_conflicts(
        reader_res.raddrs, reader_res.rn, reader_res.waddrs, reader_res.wn,
        writer_res.waddrs, writer_res.wn, n_objects, reads_only=reads_only)
    earlier = writer_mask[None, :] & (rank[None, :] < rank[:, None])
    return (mat & earlier).any(dim=1)


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


def wave_commit(res: TxnResult, conflict: torch.Tensor | None,
                pending: torch.Tensor, rank: torch.Tensor, n_objects: int,
                block: int = 1) -> tuple[torch.Tensor, int]:
    """OCC's arrival-order wave rule: c[t] = pending[t] and no earlier q
    with c[q] conflicts with t (the greedy kernel of the conflict DAG; no
    prefix rule).  Solved by fixpoint iteration from c = pending, ``block``
    conflict queries per trip, the convergence test (one host sync) only
    after the block, as the reference's unrolled ``while_loop`` trip does.
    Returns ``(committing, trips)``: the trip count, final converging
    trip included, is what ``ExecTrace.wave_trips`` sums."""
    c, trips = pending, 0
    while True:
        start = c
        for _ in range(block):
            blocked = earlier_writer_conflicts(res, conflict, c, rank,
                                               n_objects)
            c = pending & ~blocked
        trips += 1
        if bool((c == start).all()):
            return c, trips


def fused_write_back(values, versions, waddrs, wvals, wn, committing, rank,
                     seq_nos, layout: StoreLayout | None = None):
    """Install a whole round of commits in one scatter, in place.  The
    winning writer per address has the largest (rank, slot) priority:
    later committers overwrite earlier ones and, within a transaction,
    the later deferred write wins.  Priorities are unique, so exactly
    one slot per address is scattered.

    Under a sharded ``layout`` the round splits into S independent
    scatters, one into each shard's slice (an address lives in exactly
    one shard, so each shard's winners come from exactly the writes the
    dense scatter would route there).  Under a mesh each rank runs only
    its own shard's scatter (the reference's ``shard_map`` body), and
    nothing crosses ranks."""
    if layout is not None and layout.mesh is not None:
        _shard_write_back(values[0], versions[0], layout.rank, waddrs, wvals,
                          wn, committing, rank, seq_nos, layout.shard_size)
        return values, versions
    if layout is not None and layout.sharded:
        for s in range(layout.shards):
            _shard_write_back(values[s], versions[s], s, waddrs, wvals, wn,
                              committing, rank, seq_nos, layout.shard_size)
        return values, versions
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
