"""Elastic scaling, deterministically (paper §2.1 applied to workers),
the port's own copy of ``repro.runtime.elastic`` (it has no tensor code).

Pot treats thread start/stop as sequenced events; we treat WORKER
join/leave the same way.  The ElasticLaneManager wraps the round-robin
sequencer's lane tree: a joining worker is spawned as a child lane of the
coordinator lane and only starts receiving sequence numbers at a
deterministic point in the order; a leaving worker's lane is stopped the
same way.  Two runs with the same join/leave schedule (in *logical* time,
i.e. sequence positions — not wall-clock) produce identical transaction
orders, so scaling events never fork replicas.

The manager is wired through ``PotSession`` (the session's ``elastic``
attribute / ``serve(..., elastic=...)``): before executing the batch
formed at index b the session calls ``advance_to(b + 1)`` — scaling
events take effect at *formed-batch boundaries*, which are positions in
the deterministic order — and maps each row's client lane to a live
worker lane via :meth:`worker_for`.  The manager's state (events + the
round cursor) is snapshot-visible (:meth:`state_dict` /
:meth:`from_state`, carried by ``repro_torch.core.checkpoint``
manifests), so a replica restored across a scaling event numbers lanes
identically to the uninterrupted run.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.sequencer import RoundRobinSequencer


@dataclasses.dataclass
class ScalingEvent:
    at_round: int          # logical round when the event takes effect
    action: str            # "join" | "leave"
    lane_id: int | None = None
    parent: int = 0


class ElasticLaneManager:
    """Deterministic worker pool: schedule(events) -> per-round lane sets
    and a sequencer whose numbering reflects joins/leaves."""

    def __init__(self, n_initial: int, events: list[ScalingEvent] = ()):
        self.n_initial = int(n_initial)
        self.seq = RoundRobinSequencer(n_root_lanes=n_initial)
        self.events = sorted(events, key=lambda e: (e.at_round, e.action,
                                                    e.lane_id or -1))
        self._round = 0

    def advance_to(self, round_idx: int) -> None:
        """Apply all scaling events up to ``round_idx`` (deterministic
        order: sorted by (round, action, lane))."""
        for ev in self.events:
            if self._round < ev.at_round <= round_idx:
                if ev.action == "join":
                    ev.lane_id = self.seq.spawn_lane(ev.parent,
                                                     lane_id=ev.lane_id)
                else:
                    self.seq.stop_lane(ev.lane_id)
        self._round = max(self._round, round_idx)

    def live_lanes(self) -> list[int]:
        return self.seq.lane_order()

    def assign(self, txn_lanes) -> "list[int]":
        return self.seq.order_for(txn_lanes)

    def worker_for(self, key: int) -> int:
        """Deterministically place a client key on a live worker lane:
        modular assignment over the post-order lane traversal.  Pure in
        (key, lane-tree state), so two replicas at the same round map
        every key identically — including across join/leave events."""
        order = self.live_lanes()
        if not order:
            raise RuntimeError(
                "no live worker lanes: every lane has left the pool")
        return order[int(key) % len(order)]

    # ------------------------------------------------- snapshot state
    def state_dict(self) -> dict:
        """JSON-clean state: initial width, the round cursor, and the
        full event schedule (applied join events carry their assigned
        lane ids, so re-application is exact)."""
        return {
            "n_initial": self.n_initial,
            "round": self._round,
            "events": [[e.at_round, e.action, e.lane_id, e.parent]
                       for e in self.events],
        }

    @classmethod
    def from_state(cls, state: dict) -> "ElasticLaneManager":
        """Rebuild a manager at the same round: replays the event
        schedule through a fresh lane tree (spawn/stop are deterministic,
        so the tree — and therefore :meth:`worker_for` — is identical)."""
        mgr = cls(state["n_initial"],
                  [ScalingEvent(int(r), a,
                                None if l is None else int(l), int(p))
                   for r, a, l, p in state["events"]])
        mgr.advance_to(int(state["round"]))
        return mgr
