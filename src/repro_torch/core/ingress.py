"""Deterministic ingress: admission pool + priority-drain batch former
(the port's own copy of ``repro.core.ingress``; host state, numpy only).

This is the layer *above* everything the engine pipeline built: a
production system serving millions of clients never sees neat pre-built
batches — it sees a firehose of single transactions arriving on client
connections.  Pot's determinism guarantee starts at the preordered
sequence (paper §2.1), so the component that *forms* that sequence under
real traffic must itself be deterministic: two replicas fed the same
arrivals must emit bit-identical batch streams end-to-end (QueCC's
queue-oriented planning under a predefined order; Aviram et al. on
deterministic scheduling as the basis of cheap replication).

**The no-wall-clock rule.**  Nothing in this module may read a clock,
an RNG, or any other ambient nondeterminism.  Every quantity that looks
temporal is *logical*: arrivals carry a monotone integer **stamp** (the
admission counter, or a caller-supplied logical time), "age" is a stamp
difference, and priorities are integer arithmetic over (fee, age, size).
This is what makes an :class:`IngressPool` a pure state machine — its
entire behavior is a function of the admission/drain event sequence, so
the event journal IS the replication/replay substrate.

The pool does four things:

1. **Admission** (:meth:`IngressPool.admit`): a transaction enters with
   a per-client *lane* id, a *fee* (the caller's priority pressure), and
   a logical arrival *stamp*.  Capacity is bounded: when an admission
   pushes occupancy past ``capacity``, the pool deterministically evicts
   the worst-priority lane *tails* down to the ``evict_to`` watermark
   (tails, so every lane's surviving queue stays a contiguous prefix of
   its program order — no holes in a client's sequence).  Occupancy at
   or above ``backpressure_at`` raises the :attr:`backpressure` signal
   (callers should throttle; admission itself stays deterministic
   whether they do or not).  Per-client lanes are the DoS posture: one
   client's flood competes on priority like everyone else and is first
   in line for tail eviction.
2. **Per-lane sequencing**: each admitted transaction gets a per-lane
   sequence number from a :class:`~repro_torch.core.sequencer
   .RoundRobinSequencer` (lanes join/leave via :meth:`spawn_lane` /
   :meth:`stop_lane`, the paper's lane-tree events), so a lane's program
   order is preserved end-to-end: the drain never reorders two
   transactions of the same lane.
3. **Priority drain** (:meth:`IngressPool.drain`): forms a
   :class:`FormedBatch` of up to ``budget`` transactions by repeatedly
   picking the best *lane head* under the total order

       key(t) = (-effective_priority(t), lane(t), lane_seq(t))

   with ``effective_priority = fee·fee_weight - size·size_weight +
   age_weight·((latest_stamp - stamp) // age_unit)`` — fee pressure,
   size pressure, and logical-age pressure (anti-starvation: parked
   transactions climb as newer stamps arrive).  Only lane heads are
   eligible, which is what preserves per-lane order; ties break by
   (lane, lane_seq), never by arrival interleaving.  The drain order is
   the preordered sequence: the batch rows come out in drain order and
   carry globally consecutive sequence numbers, ready for
   ``PotSession.serve``.  Because the key is a pure function of pool
   state and draining removes entries without touching stamps, the flat
   drained sequence is invariant to how a drain prefix is partitioned
   into budgets: ``drain(3); drain(5)`` emits the same eight
   transactions in the same order as ``drain(8)``.
4. **Batch forming**: the drain also picks the (K, L) *bucket family*
   for the formed batch from observed queue occupancy — the recent
   drain-size history: when mid-size tails dominate (pow-of-two padding
   would waste ≥ 2× the slots of the dense {1,2,4,8} ∪ 8·n ladder), it
   recommends the ``dense`` bucket ladder, otherwise ``pow2``
   (:meth:`preferred_ladder`).  The recommendation rides on the
   FormedBatch; padding itself stays in ``PotSession`` and uses
   :func:`repro_torch.core.txn.pad_batch`'s vacant-row convention, so
   the choice can never change committed state — only compile counts
   and padding waste.

**Arrival journal.**  Every admission, lane event, and drain call is
recorded as a plain-data event tuple.  :meth:`IngressPool.replay` feeds
a journal through a fresh pool and reproduces the exact original
FormedBatch stream — admissions, evictions, drain order, sequence
numbers, bucket choices, everything.  :meth:`arrival_journal` is the
drain-free view: feed it to N replicas, let each drain under its own
budgets/interleavings, and every replica emits the same flat
transaction sequence (and therefore bit-identical stores through
``PotSession``) for any drain schedules that cover the same prefix.
Journal loading is defensive: :meth:`IngressPool.replay` /
:meth:`IngressPool.apply` validate every event (shape, kind, arity,
field types, stamp monotonicity) and raise :class:`JournalError` with
the failing index instead of diverging on a truncated, reordered, or
corrupted feed — a replica must prove its feed well-formed before
serving it (the reference's failover restore path rides on
``apply``).
"""

from __future__ import annotations

import dataclasses
import heapq
from collections import deque
from typing import Iterable, Sequence

import numpy as np

from repro_torch.core.sequencer import RoundRobinSequencer
from repro_torch.core.txn import TxnBatch, make_batch, next_pow2

# journal event kinds (plain tuples so a journal is transport-friendly)
EV_CONFIG, EV_SPAWN, EV_STOP, EV_ADMIT, EV_DRAIN = (
    "config", "spawn", "stop", "admit", "drain")

# the knobs that must match between replicas for bit-identical behavior;
# they travel in the journal's leading config event
_CONFIG_KEYS = ("capacity", "evict_to", "backpressure_at", "fee_weight",
                "age_weight", "age_unit", "size_weight",
                "ladder_window")

# event arity per kind (including the kind tag itself) — the cheap
# structural gate journal loading applies before touching pool state
_EV_ARITY = {EV_CONFIG: 2, EV_SPAWN: 3, EV_STOP: 2, EV_ADMIT: 5,
             EV_DRAIN: 2}


class JournalError(ValueError):
    """A journal failed validation: truncated, reordered, or corrupted.

    Raised by :meth:`IngressPool.replay` / :meth:`IngressPool.apply`
    with the failing event's index, instead of letting a malformed
    tuple fail deep inside drain/``make_batch`` with an opaque shape
    error.  The journal IS the replication substrate — a replica must
    refuse a feed it cannot prove well-formed rather than diverge.
    """


@dataclasses.dataclass(frozen=True)
class _Entry:
    """One admitted transaction parked in the pool."""

    txn_id: int        # admission id (global counter, 0-based)
    lane: int          # client lane
    lane_seq: int      # per-lane sequence number (RoundRobinSequencer)
    stamp: int         # logical arrival stamp (monotone, no wall-clock)
    fee: int           # caller priority pressure
    program: tuple     # ((op, addr, indirect, operand), ...) — immutable

    @property
    def size(self) -> int:
        return len(self.program)


@dataclasses.dataclass(frozen=True)
class AdmitResult:
    """Outcome of one admission attempt."""

    admitted: bool
    txn_id: int                   # -1 when rejected outright
    stamp: int
    lane_seq: int                 # -1 when rejected outright
    evicted: tuple[int, ...]      # txn_ids evicted by this admission
    #                               (may include txn_id itself: the
    #                               incoming txn lost the watermark
    #                               eviction and admitted is False)
    backpressure: bool            # pool at/over the backpressure mark
    reason: str = ""


@dataclasses.dataclass
class PoolStats:
    """Monotone ingress counters (the metrics CSV observables)."""

    admitted: int = 0             # accepted and still-or-once pooled
    rejected: int = 0             # refused outright (stopped lane, ...)
    evicted: int = 0              # watermark-evicted after admission
    drained: int = 0              # handed to a FormedBatch
    drain_calls: int = 0
    backpressure_admits: int = 0  # admissions while the signal was up


@dataclasses.dataclass
class FormedBatch:
    """One drained batch: the preordered sequence segment it represents.

    Rows are in drain order; ``seq`` is globally consecutive across the
    pool's lifetime (1-based), so the drain order IS the serialization
    order when submitted through ``PotSession.serve``.
    """

    batch: TxnBatch
    lanes: np.ndarray      # (K,) client lane per row
    seq: np.ndarray        # (K,) global sequence numbers, ascending
    txn_ids: np.ndarray    # (K,) admission ids (journal cross-reference)
    stamps: np.ndarray     # (K,) logical arrival stamps
    ladder: str            # occupancy-recommended bucket family
    budget: int            # the drain budget that formed this batch

    @property
    def n_txns(self) -> int:
        return self.batch.n_txns


def programs_from_batch(batch: TxnBatch) -> list[tuple]:
    """Invert :func:`repro_torch.core.txn.make_batch`: recover each row's
    live instruction tuple — the admission-side representation.  Lets
    existing workload generators feed an IngressPool."""
    op, ad, ind, opr, n = (getattr(batch, f).cpu().numpy() for f in
                           ("opcodes", "addrs", "indirect", "operands",
                            "n_ins"))
    return [tuple((int(op[i, j]), int(ad[i, j]), bool(ind[i, j]),
                   int(opr[i, j])) for j in range(int(n[i])))
            for i in range(op.shape[0])]


def dense_bucket(k: int) -> int:
    """The denser small-K serving ladder: {1, 2, 4, 8} below 8, then
    multiples of 8 (mirrors ``PotSession``'s ``bucket_ladder="dense"``)."""
    if k <= 8:
        return next_pow2(k)
    return -(-k // 8) * 8


class IngressPool:
    """Deterministic admission pool + priority-drain batch former.

    Args:
      capacity: hard bound on parked transactions.  An admission that
        pushes occupancy past it triggers watermark eviction.
      evict_to: occupancy the eviction drains down to (default
        ``3 * capacity // 4``) — eviction runs in bursts so each
        overflow pays once, not per admission.
      backpressure_at: occupancy at which :attr:`backpressure` raises
        (default ``evict_to``).  Purely a signal — admission semantics
        do not change, so replicas with and without throttling callers
        stay deterministic.
      fee_weight / age_weight / age_unit / size_weight: integer priority
        formula knobs (see the module docstring).  ``age_unit <= 0``
        disables age pressure.
      ladder_window: how many recent drain sizes inform
        :meth:`preferred_ladder`.

    All knobs are recorded in the journal's config event, so
    :meth:`replay` reconstructs an identically-configured pool.
    """

    def __init__(self, capacity: int = 4096, *, evict_to: int | None = None,
                 backpressure_at: int | None = None, fee_weight: int = 16,
                 age_weight: int = 1, age_unit: int = 64,
                 size_weight: int = 1, ladder_window: int = 64):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.evict_to = (int(evict_to) if evict_to is not None
                         else max(1, (3 * self.capacity) // 4))
        if not 0 < self.evict_to <= self.capacity:
            raise ValueError(
                f"evict_to must be in [1, capacity], got {self.evict_to}")
        self.backpressure_at = (int(backpressure_at)
                                if backpressure_at is not None
                                else self.evict_to)
        self.fee_weight = int(fee_weight)
        self.age_weight = int(age_weight)
        self.age_unit = int(age_unit)
        self.size_weight = int(size_weight)
        self.ladder_window = int(ladder_window)
        # lane lifecycle + per-lane sequence numbers ride the paper's
        # sequencer; the pool's lanes are RoundRobinSequencer lanes
        self._seqr = RoundRobinSequencer(n_root_lanes=0)
        self._queues: dict[int, deque[_Entry]] = {}
        self._stopped: set[int] = set()
        self._depth = 0
        self._stamp = 0           # latest logical arrival stamp
        self._next_txn_id = 0
        self._drain_seq = 0       # global seq numbers handed out so far
        self._drain_sizes: list[int] = []
        self.stats = PoolStats()
        self._journal: list[tuple] = [
            (EV_CONFIG, {k: getattr(self, k) for k in _CONFIG_KEYS})]

    # ------------------------------------------------------------ lanes
    def spawn_lane(self, lane_id: int, parent: int | None = None) -> int:
        """Register a client lane (journaled).  ``parent`` threads the
        paper's lane tree through the round-robin sequencer; root lanes
        (no parent) order by id."""
        lane_id = int(lane_id)
        if lane_id in self._seqr.lanes:
            raise ValueError(f"lane {lane_id} already exists")
        if parent is None:
            self._seqr.ensure_lane(lane_id)
        else:
            self._seqr.spawn_lane(int(parent), lane_id)
        self._queues.setdefault(lane_id, deque())
        self._journal.append((EV_SPAWN, lane_id,
                              None if parent is None else int(parent)))
        return lane_id

    def stop_lane(self, lane_id: int) -> None:
        """Stop a lane (journaled): already-parked transactions still
        drain in order, but new admissions on the lane are rejected and
        the round-robin refill stops feeding it."""
        lane_id = int(lane_id)
        if lane_id not in self._seqr.lanes:
            raise KeyError(f"unknown lane {lane_id}")
        self._seqr.stop_lane(lane_id)
        self._stopped.add(lane_id)
        self._journal.append((EV_STOP, lane_id))

    # -------------------------------------------------------- admission
    @property
    def depth(self) -> int:
        """Parked transactions right now (the queue-depth observable)."""
        return self._depth

    def __len__(self) -> int:
        return self._depth

    @property
    def backpressure(self) -> bool:
        """True when occupancy is at/over the backpressure watermark —
        the deterministic "slow down" signal for admission callers."""
        return self._depth >= self.backpressure_at

    def _eff_priority(self, e: _Entry) -> int:
        age = ((self._stamp - e.stamp) // self.age_unit
               if self.age_unit > 0 else 0)
        return (e.fee * self.fee_weight - e.size * self.size_weight
                + age * self.age_weight)

    def _drain_key(self, e: _Entry) -> tuple[int, int, int]:
        """The total drain order: best-first under
        (-priority, lane, lane_seq).  Pure in (entry, pool stamp)."""
        return (-self._eff_priority(e), e.lane, e.lane_seq)

    def admit(self, program: Sequence[tuple], *, lane: int = 0,
              fee: int = 0, stamp: int | None = None) -> AdmitResult:
        """Admit one transaction (journaled).

        ``program`` is the transaction's instruction list
        (``(opcode, addr, indirect, operand)`` tuples — the
        :func:`make_batch` row form).  ``stamp`` defaults to the next
        logical instant; an explicit stamp must be >= the latest one
        (callers may admit a *group* under one stamp — drain order over
        distinct lanes is then invariant to the admission order within
        the group, because the drain key never consults arrival
        interleaving).
        """
        lane = int(lane)
        program = tuple(tuple(ins) for ins in program)
        if not program:
            raise ValueError(
                "empty program: an n_ins == 0 row is the vacant-row "
                "padding convention and would never commit; admit a "
                "single NOP instead")
        for i, ins in enumerate(program):
            # fail at admission, not deep inside drain's make_batch
            if len(ins) != 4:
                raise ValueError(
                    f"program instruction {i} has {len(ins)} fields, "
                    f"expected 4 (opcode, addr, indirect, operand): "
                    f"{ins!r}")
        if lane in self._stopped:
            self.stats.rejected += 1
            return AdmitResult(False, -1, self._stamp, -1, (),
                               self.backpressure, reason="lane stopped")
        if stamp is None:
            stamp = self._stamp + 1
        else:
            stamp = int(stamp)
            if stamp < self._stamp:
                raise ValueError(
                    f"stamps must be non-decreasing: got {stamp} after "
                    f"{self._stamp} (logical time cannot run backwards)")
        bp = self.backpressure
        if bp:
            self.stats.backpressure_admits += 1
        self._stamp = stamp
        if lane not in self._seqr.lanes:
            self._seqr.ensure_lane(lane)
            self._queues.setdefault(lane, deque())
        self._journal.append((EV_ADMIT, stamp, lane, int(fee), program))
        lane_seq = self._seqr.get_seq_no(lane)
        entry = _Entry(self._next_txn_id, lane, lane_seq, stamp,
                       int(fee), program)
        self._next_txn_id += 1
        self._queues[lane].append(entry)
        self._depth += 1
        self.stats.admitted += 1
        evicted: tuple[int, ...] = ()
        if self._depth > self.capacity:
            evicted = self._evict_down_to(self.evict_to)
        admitted = entry.txn_id not in evicted
        return AdmitResult(admitted, entry.txn_id, stamp, lane_seq,
                           evicted, bp,
                           reason="" if admitted else "evicted at admission")

    def admit_many(self, txns: Iterable[tuple], *,
                   stamp: int | None = None) -> list[AdmitResult]:
        """Admit a group of ``(program, lane, fee)`` tuples under one
        logical stamp (defaults to the next instant).  Drain order over
        the group's distinct lanes is invariant to its internal order."""
        txns = list(txns)
        if stamp is None:
            stamp = self._stamp + 1
        return [self.admit(p, lane=l, fee=f, stamp=stamp)
                for p, l, f in txns]

    def _evict_down_to(self, target: int) -> tuple[int, ...]:
        """Deterministic watermark eviction: drop worst-priority lane
        *tails* (largest drain key) until occupancy <= target.  Tails
        keep every lane's surviving queue a contiguous prefix of its
        program order."""
        evicted: list[int] = []
        while self._depth > target:
            worst_lane, worst_key = -1, None
            for lane in sorted(self._queues):
                q = self._queues[lane]
                if not q:
                    continue
                key = self._drain_key(q[-1])
                if worst_key is None or key > worst_key:
                    worst_key, worst_lane = key, lane
            if worst_lane < 0:      # pragma: no cover - depth bookkeeping
                break
            e = self._queues[worst_lane].pop()
            self._depth -= 1
            self.stats.evicted += 1
            evicted.append(e.txn_id)
        return tuple(evicted)

    # ------------------------------------------------------------ drain
    def preferred_ladder(self) -> str:
        """Occupancy-driven bucket-family choice for the formed batches:
        ``dense`` when the recent drain sizes' pow2 padding would waste
        at least twice the slots of the dense {1,2,4,8} ∪ 8·n ladder,
        else ``pow2``.  Deterministic in the drain-size history."""
        ks = self._drain_sizes[-self.ladder_window:]
        if not ks:
            return "pow2"
        waste_p = sum(next_pow2(k) - k for k in ks)
        waste_d = sum(dense_bucket(k) - k for k in ks)
        return "dense" if waste_p > 0 and 2 * waste_d <= waste_p \
            else "pow2"

    def drain(self, budget: int) -> FormedBatch | None:
        """Form the next batch: up to ``budget`` transactions in drain
        order (journaled).  Returns None when the pool is empty.

        Pure in (pool state, budget): repeatedly pops the lane head with
        the smallest ``(-priority, lane, lane_seq)`` key.  Priorities are
        fixed for the duration of the call (stamps only advance on
        admission), so partitioning a drain prefix into budgets cannot
        change the flat drained sequence."""
        budget = int(budget)
        if budget < 1:
            raise ValueError(f"drain budget must be >= 1, got {budget}")
        self._journal.append((EV_DRAIN, budget))
        self.stats.drain_calls += 1
        heap = [(self._drain_key(q[0]), lane)
                for lane, q in self._queues.items() if q]
        heapq.heapify(heap)
        picked: list[_Entry] = []
        while heap and len(picked) < budget:
            _, lane = heapq.heappop(heap)
            q = self._queues[lane]
            picked.append(q.popleft())
            if q:
                heapq.heappush(heap, (self._drain_key(q[0]), lane))
        if not picked:
            return None
        k = len(picked)
        self._depth -= k
        self.stats.drained += k
        self._drain_sizes.append(k)
        # formed on the host; PotSession moves it to its device
        batch = make_batch([list(e.program) for e in picked], device="cpu")
        base = self._drain_seq
        self._drain_seq += k
        return FormedBatch(
            batch=batch,
            lanes=np.asarray([e.lane for e in picked], np.int64),
            seq=np.arange(base + 1, base + k + 1, dtype=np.int64),
            txn_ids=np.asarray([e.txn_id for e in picked], np.int64),
            stamps=np.asarray([e.stamp for e in picked], np.int64),
            ladder=self.preferred_ladder(), budget=budget)

    def drain_all(self, budget: int) -> list[FormedBatch]:
        """Drain to empty in ``budget``-sized batches."""
        out = []
        while True:
            fb = self.drain(budget)
            if fb is None:
                return out
            out.append(fb)

    # ---------------------------------------------------------- journal
    def journal(self) -> list[tuple]:
        """The full event journal (config, lane events, admissions,
        drains) — plain tuples, replayable via :meth:`replay`."""
        return list(self._journal)

    def arrival_journal(self) -> list[tuple]:
        """The drain-free journal view: config + lane events +
        admissions.  Feed it to replicas that choose their own drain
        schedules — any schedules covering the same drain prefix emit
        the same flat transaction sequence."""
        return [ev for ev in self._journal if ev[0] != EV_DRAIN]

    @staticmethod
    def _check_event(ev, index: int) -> tuple:
        """Structural validation of one journal event (defensive journal
        loading): shape, kind, arity, field types.  Accepts the tuple
        form and its JSON round-trip (lists); raises
        :class:`JournalError` naming the failing index."""
        if not isinstance(ev, (tuple, list)) or not ev:
            raise JournalError(
                f"journal event {index} is not an event tuple: {ev!r} "
                "(journal corrupted?)")
        kind = ev[0]
        if kind not in _EV_ARITY:
            raise JournalError(
                f"journal event {index} has unknown kind {kind!r} "
                "(journal corrupted?)")
        if len(ev) != _EV_ARITY[kind]:
            raise JournalError(
                f"journal event {index} ({kind!r}) has {len(ev)} fields, "
                f"expected {_EV_ARITY[kind]} — truncated or corrupted "
                f"event: {ev!r}")
        if kind == EV_ADMIT:
            _, stamp, lane, fee, program = ev
            for field, val in (("stamp", stamp), ("lane", lane),
                               ("fee", fee)):
                if not isinstance(val, (int, np.integer)) \
                        or isinstance(val, bool):
                    raise JournalError(
                        f"journal event {index} (admit) has non-integer "
                        f"{field} {val!r} (journal corrupted?)")
            if not isinstance(program, (tuple, list)) or not program:
                raise JournalError(
                    f"journal event {index} (admit) has no program "
                    f"(truncated event?): {program!r}")
            for i, ins in enumerate(program):
                if not isinstance(ins, (tuple, list)) or len(ins) != 4:
                    raise JournalError(
                        f"journal event {index} (admit) instruction {i} "
                        f"is not a 4-field tuple: {ins!r} (journal "
                        "corrupted?)")
        elif kind in (EV_SPAWN, EV_STOP, EV_DRAIN):
            if not isinstance(ev[1], (int, np.integer)) \
                    or isinstance(ev[1], bool):
                raise JournalError(
                    f"journal event {index} ({kind!r}) has non-integer "
                    f"argument {ev[1]!r} (journal corrupted?)")
        return tuple(ev)

    def apply(self, events: Iterable[tuple], *,
              base_index: int = 0) -> list[FormedBatch]:
        """Apply a validated journal suffix to THIS pool (the restore /
        catch-up path: a replica restored from a snapshot feeds the
        arrival-journal events its snapshot had not yet seen).

        Every event is structurally validated before touching pool
        state, and semantic violations (a stamp running backwards = a
        reordered journal; lane events against an impossible lane tree)
        are wrapped as :class:`JournalError` with the failing event's
        index.  Returns the FormedBatches produced by replayed drains.
        """
        formed: list[FormedBatch] = []
        for i, ev in enumerate(events):
            index = base_index + i
            ev = self._check_event(ev, index)
            kind = ev[0]
            if kind == EV_CONFIG:
                raise JournalError(
                    f"journal event {index} is a config event mid-"
                    "journal — journals were concatenated or reordered")
            try:
                if kind == EV_SPAWN:
                    self.spawn_lane(ev[1], parent=ev[2])
                elif kind == EV_STOP:
                    self.stop_lane(ev[1])
                elif kind == EV_ADMIT:
                    _, stamp, lane, fee, program = ev
                    self.admit(program, lane=lane, fee=fee, stamp=stamp)
                else:   # EV_DRAIN (kinds are exhaustive per _check_event)
                    fb = self.drain(ev[1])
                    if fb is not None:
                        formed.append(fb)
            except JournalError:
                raise
            except (KeyError, ValueError) as e:
                raise JournalError(
                    f"journal event {index} ({kind!r}) cannot apply: {e} "
                    "— reordered or corrupted journal") from e
        return formed

    @classmethod
    def replay(cls, journal: Iterable[tuple]
               ) -> tuple["IngressPool", list[FormedBatch]]:
        """Feed a journal through a fresh pool.  Reproduces the original
        pool bit-exactly: admissions (with their original stamps),
        evictions, lane events, and — for journaled drains — the exact
        FormedBatch stream, in order.  Returns ``(pool, formed)``.

        Defensive by construction (:class:`JournalError`): the journal
        must lead with a well-formed config event carrying exactly the
        replica-affecting knobs, and every subsequent event is validated
        by :meth:`apply` before it touches pool state."""
        journal = list(journal)
        if not journal:
            raise JournalError("empty journal: not even a config event "
                               "(was the feed truncated?)")
        head = cls._check_event(journal[0], 0)
        if head[0] != EV_CONFIG:
            raise JournalError(
                "journal must start with its config event (was this "
                "sliced without IngressPool.journal()?)")
        cfg = head[1]
        if not isinstance(cfg, dict) or set(cfg) != set(_CONFIG_KEYS):
            raise JournalError(
                f"journal config event carries keys "
                f"{sorted(cfg) if isinstance(cfg, dict) else cfg!r}, "
                f"expected exactly {sorted(_CONFIG_KEYS)} (journal from "
                "an incompatible pool version, or corrupted)")
        pool = cls(**cfg)
        formed = pool.apply(journal[1:], base_index=1)
        return pool, formed

    # ------------------------------------------------------ observables
    def observables(self) -> dict:
        """The metrics-facing snapshot (queue depth + monotone counters
        + the backpressure signal) — what ``report_from_trace`` folds
        into its CSV columns."""
        return dict(queue_depth=self._depth,
                    admitted=self.stats.admitted,
                    rejected=self.stats.rejected,
                    evicted=self.stats.evicted,
                    drained=self.stats.drained,
                    drain_calls=self.stats.drain_calls,
                    backpressure=int(self.backpressure),
                    backpressure_admits=self.stats.backpressure_admits)
