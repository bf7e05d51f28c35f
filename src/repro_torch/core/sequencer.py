"""Ordering phase: the Pot sequencer (paper §2.1).

The sequencer runs *before* execution and assigns every transaction a
sequence number — its place in the deterministic serialization order.  It
is a host-side control-plane component by design (the whole point of
preordered transactions is that ordering is decoupled from the device
execution phase).

Implemented sequencers:

- ``RoundRobinSequencer`` — the paper's generic sequencer: derives the
  transaction order from a deterministic order over *lanes* (our threads).
  Lanes form a tree (the main lane is the root; a spawned lane is a child
  of its spawner) and the lane order is the tree's post-order traversal.
  Lane start/stop events are processed as if they were transactions, so
  the order is deterministic under *elastic scaling* (lanes joining and
  leaving mid-run) — this is how the paper handles thread create/join and
  how this framework handles workers joining/leaving a job.
- ``ReplaySequencer`` — replays a recorded commit order (record/replay
  debugging, §2.1 "application-specific sequencers").
- ``ExplicitSequencer`` — a fully explicit order; detects the hang the
  paper warns about (a lane never produces the transaction the order is
  waiting for) and raises instead of deadlocking.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

import numpy as np


@dataclasses.dataclass
class Lane:
    lane_id: int
    parent: int | None
    children: list[int] = dataclasses.field(default_factory=list)
    alive: bool = True


class RoundRobinSequencer:
    """Round-robin over the post-order lane tree (paper §2.1).

    ``get_seq_no(lane_id)`` hands out the next sequence number for that
    lane; numbers are globally consecutive starting at 1 and reflect a
    round-robin interleaving of the live lanes in post-order.
    """

    def __init__(self, n_root_lanes: int = 1):
        self.lanes: dict[int, Lane] = {
            i: Lane(i, None) for i in range(n_root_lanes)}
        self._next_sn = 1
        # per-lane FIFO of pre-assigned numbers (round-robin schedule)
        self._pending: dict[int, list[int]] = {}
        self._order_log: list[tuple[int, int]] = []  # (sn, lane)

    # -- lane tree management (start/stop are sequenced events) ----------
    def spawn_lane(self, parent: int, lane_id: int | None = None) -> int:
        new_id = lane_id if lane_id is not None else (max(self.lanes) + 1)
        assert new_id not in self.lanes
        self.lanes[new_id] = Lane(new_id, parent)
        self.lanes[parent].children.append(new_id)
        return new_id

    def ensure_lane(self, lane_id: int, parent: int | None = None) -> bool:
        """Idempotently register ``lane_id`` — as a root lane (no
        parent; roots order by id in the post-order traversal) or as a
        child of ``parent``.  Returns True when the lane was newly
        created.  The ingress pool uses this to materialize client
        lanes on first contact without racing an explicit spawn."""
        if lane_id in self.lanes:
            return False
        if parent is None:
            self.lanes[lane_id] = Lane(lane_id, None)
        else:
            self.spawn_lane(parent, lane_id)
        return True

    def stop_lane(self, lane_id: int) -> None:
        self.lanes[lane_id].alive = False

    def lane_order(self) -> list[int]:
        """Post-order traversal of the lane tree, live lanes only."""
        out: list[int] = []

        def visit(lid: int):
            for c in self.lanes[lid].children:
                visit(c)
            if self.lanes[lid].alive:
                out.append(lid)

        roots = [l.lane_id for l in self.lanes.values() if l.parent is None]
        for r in sorted(roots):
            visit(r)
        return out

    # -- sequence number assignment ---------------------------------------
    def _refill(self) -> None:
        for lid in self.lane_order():
            self._pending.setdefault(lid, []).append(self._next_sn)
            self._order_log.append((self._next_sn, lid))
            self._next_sn += 1

    def get_seq_no(self, lane_id: int) -> int:
        """Next sequence number for this lane (paper's ``get-seq-no(tid)``).

        Raises instead of spinning forever for a lane the refill loop
        will never feed (unknown, or already stopped).
        """
        if lane_id not in self.lanes:
            raise KeyError(
                f"unknown lane {lane_id!r}: spawn_lane() it (or raise "
                f"n_root_lanes) before sequencing transactions on it")
        while not self._pending.get(lane_id):
            if not self.lanes[lane_id].alive:
                raise RuntimeError(
                    f"lane {lane_id} is stopped and has no pending "
                    f"sequence numbers")
            self._refill()
        return self._pending[lane_id].pop(0)

    def order_for(self, txn_lanes: Iterable[int]) -> np.ndarray:
        """Assign sequence numbers to a whole batch of transactions given
        the lane each one runs on; returns (K,) seq numbers (1-based)."""
        return np.asarray([self.get_seq_no(l) for l in txn_lanes], np.int64)


class ReplaySequencer:
    """Feed a previously recorded commit order back in (record/replay).

    The log may span a whole *stream* of batches (as recorded by
    ``PotSession.replay_log()``): entries are global 0-based txn ids in
    commit order, and each ``order_for`` call consumes the next batch's
    worth of entries, converting global ids to batch-local positions.
    For a single batch this degenerates to the classic "recorded_order[i]
    = txn index that committed i-th" form.  A stream shorter than the
    log leaves entries unconsumed — check :attr:`remaining` (0 after a
    complete replay) to detect a partial replay.
    """

    def __init__(self, recorded_order: Iterable[int]):
        self._order = [int(t) for t in recorded_order]
        self._consumed = 0   # log entries already replayed
        self._offset = 0     # txns seen so far (global -> local ids)

    @property
    def remaining(self) -> int:
        """Log entries not yet replayed (0 once the stream is complete)."""
        return len(self._order) - self._consumed

    def order_for(self, txn_lanes: Iterable[int]) -> np.ndarray:
        lanes = list(txn_lanes)
        k = len(lanes)
        if self.remaining < k:
            raise ValueError(
                f"replay log has {self.remaining} transactions left, "
                f"batch has {k}")
        chunk = self._order[self._consumed:self._consumed + k]
        local = [t - self._offset for t in chunk]
        if sorted(local) != list(range(k)):
            raise ValueError(
                f"replay log entries {chunk!r} are not a permutation of "
                f"this batch's transactions "
                f"[{self._offset}..{self._offset + k - 1}]")
        seq = np.empty(k, np.int64)
        for pos, txn_idx in enumerate(local):
            # keep sequence numbers globally increasing across the stream
            seq[txn_idx] = self._offset + pos + 1
        self._consumed += k
        self._offset += k
        return seq


class ExplicitSequencer:
    """Explicit total order over named transactions; raises on a hang
    (an ordered transaction that no lane ever executes, paper §2.1)."""

    def __init__(self, order: Iterable[str]):
        self._order = list(order)

    def order_for(self, txn_names: Iterable[str]) -> np.ndarray:
        names = list(txn_names)
        missing = [n for n in self._order if n not in names]
        if missing:
            raise RuntimeError(
                f"explicit order waits forever for {missing!r}; "
                "aborting instead of hanging (paper §2.1)")
        pos = {n: i + 1 for i, n in enumerate(self._order)}
        extra = [n for n in names if n not in pos]
        if extra:
            raise RuntimeError(f"transactions not in explicit order: {extra!r}")
        return np.asarray([pos[n] for n in names], np.int64)


def sequencer_state(seq) -> dict:
    """Serialize a sequencer's cursor as a JSON-clean dict (the snapshot
    form — repro.core.checkpoint stores it in the manifest).

    The three built-in sequencers round-trip exactly through
    :func:`sequencer_from_state`; anything else serializes as an
    ``{"type": "opaque"}`` marker, and restoring such a snapshot
    requires passing an explicitly reconstructed ``sequencer=``.
    """
    if isinstance(seq, RoundRobinSequencer):
        return {
            "type": "round_robin",
            "lanes": [[l.lane_id, l.parent, list(l.children), l.alive]
                      for l in seq.lanes.values()],
            "next_sn": seq._next_sn,
            "pending": {str(k): list(v) for k, v in seq._pending.items()},
            "order_log": [[sn, lid] for sn, lid in seq._order_log],
        }
    if isinstance(seq, ReplaySequencer):
        return {"type": "replay", "order": list(seq._order),
                "consumed": seq._consumed, "offset": seq._offset}
    if isinstance(seq, ExplicitSequencer):
        return {"type": "explicit", "order": list(seq._order)}
    return {"type": "opaque", "class": type(seq).__name__}


def sequencer_from_state(state: dict):
    """Rebuild a sequencer from :func:`sequencer_state` output — the
    restored cursor continues the SAME global numbering, which is what
    lets a restored replica rejoin the serialization order mid-stream."""
    kind = state["type"]
    if kind == "round_robin":
        s = RoundRobinSequencer(n_root_lanes=0)
        s.lanes = {
            int(l[0]): Lane(int(l[0]),
                            None if l[1] is None else int(l[1]),
                            [int(c) for c in l[2]], bool(l[3]))
            for l in state["lanes"]}
        s._next_sn = int(state["next_sn"])
        s._pending = {int(k): [int(x) for x in v]
                      for k, v in state["pending"].items()}
        s._order_log = [(int(sn), int(lid))
                        for sn, lid in state["order_log"]]
        return s
    if kind == "replay":
        s = ReplaySequencer(state["order"])
        s._consumed = int(state["consumed"])
        s._offset = int(state["offset"])
        return s
    if kind == "explicit":
        return ExplicitSequencer(state["order"])
    raise ValueError(
        f"cannot reconstruct sequencer state of type {kind!r}; restore "
        "with an explicit sequencer= instead")


def seq_to_order(seq: np.ndarray) -> np.ndarray:
    """(K,) 1-based sequence numbers -> (K,) permutation: order[p] = txn
    index holding sequence position p+1."""
    return np.argsort(seq, kind="stable")
