"""The DeSTM analog, the state of the art Pot is measured against (paper
§5, Fig. 10), after ``repro.core.destm``.

DeSTM divides time into *rounds*: in each round every lane executes at
most one transaction, commits follow a deterministic token order within
the round, and a barrier separates rounds.  A transaction that conflicts
with an earlier commit of its round re-executes while holding the token.

A round: membership is a per-lane scatter-min (the first pending
position of each lane); the round's at most ``n_lanes`` members are
compacted into an (n_lanes, L) block in token order (= sequence order)
and executed there (``protocol.refresh_round_state_gathered``).  The
token-order commit walk inside a round has two modes, equal in the
store and in every trace field except ``retry_waves`` /
``waves_per_round``:

* the **serial token walk** (``wave=False``): one retry event per trip.
  Batched checks find the first member that conflicts (against the
  writes committed by earlier trips, and the speculative writes of the
  clean members ahead of it); the clean block before it lands in one
  fused write-back, and only that member re-executes, holding the token.
* **wave retries** (``wave=True``, the default): each trip re-executes
  every conflicting member at once against the committed-so-far image,
  then commits the longest token-order prefix it can prove equal to the
  serial walk: each row classifies as it did at the trip's start once
  earlier wave members' speculative writes are swapped for their
  re-executed ones, and a re-executed row read nothing an earlier prefix
  row commits this trip (``protocol.cross_writer_conflicts``, the pair
  kernel's strips).  A row that fails either check re-executes next trip.

DeSTM carries no conflict table (``init_round_state(track_conflict=
False)``): its questions live on the compact block, in the scatter-min
form (``earlier_writer_conflicts(..., None, ...)``) and the pair kernel's
strips.  The reference's ``while_loop`` s are host loops here, with one
sync per round and a few per trip.

With a ``seed`` (cross-batch pipelining), round 0's members take their
rows from the re-based speculation (``protocol.seed_round_state``, whose
table is dropped so the carried state is the unseeded loop's) and round
0 charges its accounting without re-walking them.

A lane with n transactions needs at least n rounds, and every member
waits at the barrier for the slowest one (``barrier_ops``): the cost
structure of the paper's Fig. 7/9/10.  The final store equals PoGL's
under the same order.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import protocol
from repro_torch.core.engine import (EngineDef, ExecTrace, make_trace,
                                     rank_from_order,
                                     register_engine, seq_rank)
from repro_torch.core.tstore import TStore, flat_values, store_with
from repro_torch.core.txn import TxnBatch, run_live, run_txn

_I32 = torch.int32

# the old per-engine trace name, kept as an alias of the one schema
DestmTrace = ExecTrace


def _destm_execute(store: TStore, batch: TxnBatch, seq: torch.Tensor,
                   lanes: torch.Tensor, n_lanes: int,
                   max_rounds: int | None = None,
                   incremental: bool = True,
                   compact: bool = True,
                   wave: bool = True,
                   seed: protocol.SpecSeed | None = None
                   ) -> tuple[TStore, ExecTrace]:
    """Execute a batch under DeSTM.

    Args:
      store: committed store of either layout; not modified (the engine works on a copy
             of its image).
      batch: K transactions on the store's device.  Rows with
             ``n_ins == 0`` are vacant: never round members, never
             committed, no ``gv`` advance; their sequence numbers must
             sort after every real row's.
      seq:   (K,) 1-based sequence numbers; token order within a round is
             the sequence order restricted to the round's members.
      lanes: (K,) lane of each transaction, in [0, n_lanes).
      max_rounds: round limit (default K + 1, enough to commit all).
      incremental: execute only the round's members (False executes
             every row every round).
      compact: execute the members as a gathered (n_lanes, L) block
             rather than masked over (K, L); only with ``incremental``.
      wave:  wave retries (module docstring); False takes the serial
             token walk.
      seed:  a :class:`protocol.SpecSeed`: round 0's members ran against
             an earlier store and are re-based; the store and trace equal
             the unseeded call's but for the ``spec_*`` fields.
    Returns:
      (new store, trace); ``new_store.gv`` is ``store.gv`` plus the
      number of real rows.
    """
    k = batch.n_txns
    dev = store.device
    layout = store.layout     # dense or S contiguous range shards
    n_obj = layout.n_objects
    order = torch.argsort(seq, stable=True)
    rank = rank_from_order(order)
    gv0 = int(store.gv)
    lane_slot = torch.arange(n_lanes, device=dev)
    lanes = lanes.long()
    real = batch.n_ins > 0
    n_real = real.sum(dtype=_I32)
    limit = max_rounds if max_rounds is not None else k + 1
    tr = dict(commit_round=torch.full((k,), -1, dtype=_I32, device=dev),
              retries=torch.zeros((k,), dtype=_I32, device=dev),
              exec_ops=torch.zeros((), dtype=_I32, device=dev),
              barrier_ops=torch.zeros((), dtype=_I32, device=dev),
              live_per_round=torch.full((limit,), -1, dtype=_I32,
                                        device=dev),
              retry_waves=0,
              waves_per_round=torch.full((limit,), -1, dtype=_I32,
                                         device=dev))

    def round_body(rs, done, rnd):
        # ---- membership: the first pending txn (in seq order) per lane
        pending_t = ~done
        first_per_lane = torch.full((n_lanes,), k, dtype=torch.int64,
                                    device=dev)
        first_per_lane.scatter_reduce_(0, lanes,
                                       torch.where(pending_t, rank, k),
                                       "amin", include_self=True)
        sel_t = pending_t & (first_per_lane[lanes] == rank)

        # ---- the members in token order; empty lanes at the back with
        # the sentinel position k
        sel_pos = torch.sort(first_per_lane).values
        live = sel_pos < k
        sel_txn = order[sel_pos.clamp(0, k - 1)]

        # ---- speculative execution of the members only; a seeded round
        # 0 takes the re-based rows (executed against the batch-start
        # image, as round 0's members are) and charges the accounting
        seeded0 = seed is not None and rnd == 0
        if incremental and compact:
            live_t = sel_t
            if seeded0:
                rs = protocol.charge_round_state(rs, batch, sel_t, n_lanes)
                cres = rs.res.map(lambda a: a[sel_txn])
            else:
                rs, cres = protocol.refresh_round_state_gathered(
                    rs, batch, sel_txn, live, layout)
        else:
            live_t = sel_t if incremental else torch.ones_like(real)
            if seeded0:
                rs = protocol.charge_round_state(rs, batch, live_t, k)
            else:
                rs = protocol.refresh_round_state(rs, batch, live_t, layout)
            cres = rs.res.map(lambda a: a[sel_txn])
        values, versions = rs.values, rs.versions
        sn_c = gv0 + 1 + sel_pos                     # version stamps
        cbatch = batch.rows(sel_txn)
        ra_c, rn_c, wa_c, wv_c, wn_c = (cres.raddrs, cres.rn, cres.waddrs,
                                        cres.wvals, cres.wn)

        # ---- token-order commits (both modes share the prologue)
        written = torch.zeros((n_obj,), dtype=torch.bool, device=dev)
        remaining = live.clone()
        retried = torch.zeros((n_lanes,), dtype=torch.bool, device=dev)
        waves = 0
        while bool(remaining.any()):
            accum_hit = protocol.footprint_conflicts(written, ra_c, rn_c,
                                                     wa_c, wn_c)
            spec_hit = protocol.earlier_writer_conflicts(
                cres, None, remaining, lane_slot, n_obj)
            bad = remaining & (accum_hit | spec_hit)
            f = int(torch.where(bad, lane_slot, n_lanes).min())
            clean = remaining & (lane_slot < f)
            protocol.fused_write_back(values, versions, wa_c, wv_c, wn_c,
                                      clean, lane_slot, sn_c, layout)
            protocol.mark_writes(written, wa_c, torch.where(clean, wn_c, 0))
            if f == n_lanes:
                break   # the rest was clean and has committed
            waves += 1
            if not wave:
                # token held: the first conflicting member re-executes
                # against the committed image and commits.  Mark the
                # RETRY's write set: the speculative one may differ
                _, _, wa2, wv2, wn2 = run_txn(
                    cbatch.rows(f), flat_values(values, layout), n_obj)
                protocol.apply_writes(values, versions, wa2, wv2, wn2,
                                      int(sn_c[f]), layout)
                protocol.mark_writes(written, wa2, wn2)
                retried[f] = True
                remaining = remaining & (lane_slot > f)
                continue
            # the wave: every conflicting member re-executes at once
            # against the committed-so-far image (clean prefix included,
            # other wave members' writes not)
            wres = run_live(cbatch, flat_values(values, layout), bad, cres,
                            n_obj)
            # classification agreement: swapping earlier wave members'
            # speculative writes for their re-executed ones must not
            # change a row's verdict
            hit_wave_w = protocol.cross_writer_conflicts(
                cres, wres, bad, lane_slot, n_obj)
            hit_clean_spec = protocol.earlier_writer_conflicts(
                cres, None, remaining & ~bad, lane_slot, n_obj)
            class_ok = torch.where(
                bad, accum_hit | hit_clean_spec | hit_wave_w, ~hit_wave_w)
            # execution validity: a re-executed row read nothing that an
            # earlier row of the block commits this trip
            later = remaining & (lane_slot >= f)
            exec_hit = protocol.cross_writer_conflicts(
                wres, wres, later, lane_slot, n_obj, reads_only=True)
            # the longest token-order prefix of valid rows (cumulative AND)
            ok = torch.where(later, class_ok & (~bad | ~exec_hit), True)
            alive = torch.cummin(ok.to(_I32), dim=0).values.bool()
            commit2 = later & alive
            protocol.fused_write_back(values, versions, wres.waddrs,
                                      wres.wvals, wres.wn, commit2,
                                      lane_slot, sn_c, layout)
            protocol.mark_writes(written, wres.waddrs,
                                 torch.where(commit2, wres.wn, 0))
            retried = retried | (bad & commit2)
            remaining = remaining & (lane_slot >= f) & ~commit2

        # ---- trace bookkeeping: retry events back to txn ids (the live
        # members are distinct txns)
        retried_t = torch.zeros((k,), dtype=_I32, device=dev)
        retried_t[sel_txn[live]] = retried[live].to(_I32)
        tr["retries"] = tr["retries"] + retried_t
        tr["exec_ops"] = (
            tr["exec_ops"]
            + torch.where(sel_t, batch.n_ins, 0).sum(dtype=_I32)
            + torch.where(retried_t > 0, batch.n_ins, 0).sum(dtype=_I32))
        # barrier accounting: lanes idle until the slowest member finishes
        cost = torch.where(sel_t, batch.n_ins, 0)
        n_sel = sel_t.sum(dtype=_I32)
        tr["barrier_ops"] = tr["barrier_ops"] + torch.where(
            n_sel > 0, n_sel * cost.max() - cost.sum(dtype=_I32), 0)
        tr["commit_round"] = torch.where(sel_t, rnd, tr["commit_round"])
        tr["live_per_round"][rnd] = live_t.sum(dtype=_I32)
        tr["retry_waves"] += waves
        tr["waves_per_round"][rnd] = waves
        return protocol.commit_round_state(rs, values, versions), \
            done | sel_t

    if seed is not None:
        rs, spec_inv, spec_rnds = protocol.seed_round_state(
            batch, store, seed, compact=(incremental and compact))
        # DeSTM carries no table: drop the seed's, so the carried state
        # is the unseeded loop's
        rs = dataclasses.replace(rs, conflict=None, foot_bits=None,
                                 write_bits=None)
        spec = dict(spec_executed=n_real, spec_invalidated=spec_inv,
                    spec_rounds=spec_rnds)
    else:
        rs = protocol.init_round_state(batch, store.values.clone(),
                                       store.versions.clone(),
                                       track_conflict=False, layout=layout)
        spec = {}
    done, rnd = ~real, 0
    while bool((~done).any()) and rnd < limit:
        rs, done = round_body(rs, done, rnd)
        rnd += 1

    # DeSTM's serialization is round-major: rounds commit in order, and
    # the token order decides within a round, so commit_pos ranks
    # (round, rank) pairs (int32, as the reference computes it).  Excluded
    # rows (vacant, or left uncommitted by max_rounds) carry round -1 and
    # sort first: slide the committed positions down past them
    commit_round = tr["commit_round"]
    committed = commit_round >= 0
    n_excluded = (~committed).sum(dtype=_I32)
    commit_pos = seq_rank(commit_round * (k + 1) + rank.to(_I32)).to(_I32)
    commit_pos = torch.where(committed, commit_pos - n_excluded, -1).to(_I32)
    trace = make_trace(
        k, device=dev,
        commit_round=commit_round, retries=tr["retries"],
        rounds=torch.tensor(rnd, dtype=_I32, device=dev),
        exec_ops=tr["exec_ops"], barrier_ops=tr["barrier_ops"],
        live_txns=rs.live_txns, live_slots=rs.live_slots,
        walked_slots=rs.walked_slots,
        live_per_round=tr["live_per_round"],
        retry_waves=torch.tensor(tr["retry_waves"], dtype=_I32, device=dev),
        waves_per_round=tr["waves_per_round"],
        # a txn executes only in its commit round
        first_round=commit_round, commit_pos=commit_pos, **spec)
    return store_with(store, rs.values, rs.versions,
                      store.gv + n_real), trace


destm_execute = _destm_execute


def _destm_raw(store, batch, seq, lanes, n_lanes):
    return _destm_execute(store, batch, seq, lanes, n_lanes)


def _destm_raw_spec(store, batch, seq, lanes, n_lanes, seed):
    return _destm_execute(store, batch, seq, lanes, n_lanes, seed=seed)


register_engine(EngineDef(
    "destm", _destm_raw,
    doc="DeSTM analog — one txn per lane per round, barrier-separated",
    raw_spec=_destm_raw_spec))
