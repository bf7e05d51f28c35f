"""PotSession — the streaming execution layer, after
``repro.core.session``.

A session owns the store (carried across batches, with ``gv``; dense or
cut into ``shards`` contiguous range shards), the
sequencer (globally increasing sequence numbers) and its engine
(``"pcc"`` / ``"pot"``, ``"pogl"``, ``"destm"`` or ``"occ"``), all on
one device.  ``submit`` pads every batch up to its (K, L) shape bucket
with vacant NOP rows (sequence numbers past every real row's), which the
engines never commit, so fingerprints and ``replay_log()`` equal the
unpadded run's; returned traces are sliced back to the real K.  PyTorch
compiles nothing per shape, but the buckets are kept: they fix the
shapes the kernels see and make the traces comparable with the
reference's field for field.

Usage::

    session = PotSession(n_objects=1024, engine="pcc", n_lanes=8,
                         device="cuda")
    traces = session.run_stream(batches, lanes)
    session.fingerprint()                          # determinism check
    log = session.replay_log()                     # global commit order

**Deterministic ingress**: ``serve(pool, budget)`` drains an
:class:`~repro_torch.core.ingress.IngressPool` (host state; it forms
batches on the CPU from single-transaction arrivals) until it is empty.
The pool's drain order is the preordered sequence, and the formed
batches carry their own globally consecutive sequence numbers, so the
session's sequencer is not consulted.

**Cross-batch speculative pipelining**: with ``pipeline_depth=D >= 1``,
``run_stream`` and ``serve`` keep a window of up to D batches executed
speculatively ahead of the committed store: each enqueued batch runs its
round-0 read phase and conflict analysis against the store as it stands
(``protocol.spec_execute``), and at its turn the engine re-bases that
seed onto the committed store (``EngineDef.raw_spec``).  Stores,
fingerprints, ``replay_log()`` and every trace field but ``spec_*`` equal
the serial run's.  Every launch stays on the current stream: the
speculation runs before, not beside, the drains.  ``submit`` flushes the
window first.

**Crash-consistent snapshots**: ``snapshot(dir, pool=...)`` and
``PotSession.restore(dir, arrival_journal=...)`` round-trip the whole
resumable state (store image, ``gv``, sequencer cursor, counters, bucket
bookkeeping, replay log, elastic lane manager, ingress journal cursor)
through :mod:`repro_torch.core.checkpoint`.  Restoring the latest
snapshot and draining the arrival journal's suffix equals the
uninterrupted stream bit for bit; the window is flushed into a snapshot,
never persisted.  ``elastic`` attaches a
:class:`~repro_torch.runtime.elastic.ElasticLaneManager` whose join and
leave events apply at formed-batch boundaries.

**One shard per rank**: ``mesh`` (a 1-D ``DeviceMesh`` of ``shards``
ranks) cuts the store one shard per process.  Every rank builds the same
session and submits the same batches; each holds, analyses and writes
back only its own shard, loads of other shards' rows cross ranks
(``tstore.MeshRows``), and fingerprints, traces and ``replay_log()``
equal the dense session's on every rank.  Snapshots gather the shards
(rank 0 writes them) and restore into any layout.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np
import torch

from repro_torch.core import protocol
from repro_torch.core.engine import EngineDef, ExecTrace, get_engine
from repro_torch.core.sequencer import ReplaySequencer, RoundRobinSequencer
from repro_torch.core.tstore import TStore, make_store, shard_store
from repro_torch.core.tstore import fingerprint as store_fingerprint
from repro_torch.core.txn import TxnBatch, next_pow2, pad_batch

# per-transaction ExecTrace fields, sliced back to the real K after a
# bucketed submit (everything else is scalar or per-round)
_PER_TXN_FIELDS = ("commit_round", "commit_pos", "first_round", "retries",
                   "mode", "wait_rounds")


def dense_bucket(k: int) -> int:
    """The denser small-K bucket ladder: {1, 2, 4, 8} below 8, then
    multiples of 8 (K=17 runs at 24, not 32)."""
    if k <= 8:
        return next_pow2(k)
    return -(-k // 8) * 8


class PotSession:
    """Deterministic transactional execution over a stream of batches.

    Args:
      n_objects: size of a fresh store (ignored if ``store`` is given).
      slot / init: forwarded to :func:`make_store` for the fresh store.
      store: an existing store of either layout to adopt (moved to
        ``device``).
      engine: engine name (``"pcc"`` / ``"pogl"`` / ``"destm"`` /
        ``"occ"``; ``"pot"`` aliases ``"pcc"``) or an
        :class:`~repro_torch.core.engine.EngineDef`.
      sequencer: any object with ``order_for(keys) -> (K,) seq numbers``;
        defaults to a ``RoundRobinSequencer`` over ``n_lanes`` lanes.
      n_lanes: lane count (round-robin width, DeSTM round width).
      bucket: pad batch shapes up to buckets with vacant NOP rows
        (bit-identical outcome); False submits exact shapes.
      bucket_ladder: ``"pow2"`` (next power of two) or ``"dense"``
        ({1, 2, 4, 8} ∪ multiples of 8) for the K axis; L always
        buckets to powers of two.
      device: where the store lives and the engine runs (``"cuda"`` by
        default; ``"cpu"`` takes the scatter-min formulation).
      pipeline_depth: speculate up to D batches ahead of the committed
        store in ``run_stream`` / ``serve`` (module docstring); the
        outcome is the serial run's for any D.  0 (default), or an
        engine without ``raw_spec``, is the serial path.
      shards: cut the store into S contiguous range shards
        (:class:`~repro_torch.core.tstore.ShardedStore`): per-shard
        conflict analysis and write-back, every decision in global rank
        space, so fingerprints, traces and ``replay_log()`` equal the
        dense store's.  Passing it with an already sharded ``store``
        raises.
      mesh: one shard per rank: a 1-D ``DeviceMesh`` of ``shards``
        ranks (``ValueError`` for any other), every rank running this
        session alike (module docstring).
      elastic: an optional
        :class:`~repro_torch.runtime.elastic.ElasticLaneManager`
        (scaling events at formed-batch boundaries, in ``serve``).
    """

    def __init__(self, n_objects: int | None = None, *, slot: int = 1,
                 init=None, store: TStore | None = None,
                 engine: str | EngineDef = "pcc", sequencer=None,
                 n_lanes: int = 1, bucket: bool = True,
                 bucket_ladder: str = "pow2", shards: int = 1, mesh=None,
                 pipeline_depth: int = 0, elastic=None, device="cuda"):
        if pipeline_depth < 0:
            raise ValueError("pipeline_depth must be >= 0")
        if bucket_ladder not in ("pow2", "dense"):
            raise ValueError(
                f"bucket_ladder must be 'pow2' or 'dense', "
                f"got {bucket_ladder!r}")
        self.device = torch.device(device)
        if store is None:
            if n_objects is None:
                raise ValueError("PotSession needs n_objects or store")
            store = make_store(n_objects, slot=slot, init=init,
                               shards=shards, mesh=mesh, device=self.device)
        else:
            if (shards > 1 or mesh is not None) and not isinstance(store,
                                                                    TStore):
                raise ValueError(
                    "pass either an already-sharded store OR shards= with "
                    "a dense store, not both")
            store = dataclasses.replace(
                store, values=store.values.to(self.device),
                versions=store.versions.to(self.device),
                gv=store.gv.to(self.device))
            if shards > 1 or mesh is not None:
                store = shard_store(store, shards, mesh=mesh)
        self.bucket_ladder = bucket_ladder
        self.store = store
        self.engine = engine if isinstance(engine, EngineDef) \
            else get_engine(engine)
        self.n_lanes = n_lanes
        self.sequencer = sequencer if sequencer is not None \
            else RoundRobinSequencer(n_root_lanes=n_lanes)
        self.bucket = bucket
        self.pipeline_depth = pipeline_depth
        # pipelining needs the engine's seeded entry point; without one
        # the session serves the serial path, with the same outcome
        self._pipelined = (pipeline_depth > 0
                           and self.engine.raw_spec is not None)
        # the speculation window, oldest first: (batch, seq, lane_ids,
        # seed, k, bk) of each batch enqueued ahead of the store
        self._window: list[tuple] = []
        self.traces: list[ExecTrace] = []
        # replay log cache, materialized lazily in replay_log()
        self._log: list[int] = []
        self._log_batches = 0      # traces already folded into _log
        self._log_txns = 0         # Σ n_txns of those traces (id offset)
        self._n_txns = 0
        self._bucket_counts: dict[tuple[int, int], int] = {}
        # the elastic worker pool (or None): snapshot-visible state, so a
        # restored replica numbers lanes as the uninterrupted one
        self.elastic = elastic
        # failover bookkeeping: the formed-batch cursor (where a restored
        # replica re-enters its budget, snapshot and scaling schedules),
        # the snapshot chain, and the restore observables of the metrics
        self._batches_formed = 0
        self.snapshots_taken = 0
        self.restored_from = -1       # snapshot id, or -1 (never restored)
        self._chain_digest = ""       # the last committed snapshot's chain
        self._next_snapshot_id = 0

    # ------------------------------------------------------------- stream
    def _bucket_shape(self, batch: TxnBatch,
                      ladder: str | None = None) -> tuple[int, int]:
        """The (K, L) step shape a batch runs at: exact when not
        bucketing, else K up the bucket ladder and L to a power of two."""
        if not self.bucket:
            return batch.n_txns, batch.max_ins
        ladder = ladder if ladder is not None else self.bucket_ladder
        return (dense_bucket(batch.n_txns) if ladder == "dense"
                else next_pow2(batch.n_txns)), next_pow2(batch.max_ins)

    def submit(self, batch: TxnBatch, lanes: Sequence | None = None
               ) -> ExecTrace:
        """Sequence and execute one batch against the session store.

        ``lanes`` is the per-txn sequencing key (lane ids for the
        round-robin sequencer, ignored by a ``ReplaySequencer``);
        defaults to one lane.  The batch moves to the session's device,
        is padded to its bucket, and the returned trace is sliced back
        to the batch's real K rows."""
        k = batch.n_txns
        keys = list(lanes) if lanes is not None else [0] * k
        if len(keys) != k:
            raise ValueError(f"batch has {k} txns, got {len(keys)} lanes")
        # submit returns THIS batch's trace, so a speculation window left
        # pending runs first (run_stream and serve always flush theirs)
        self._spec_flush()
        seq = np.asarray(self.sequencer.order_for(keys), np.int64)
        return self._submit_seq(batch, seq, self._lane_ids(keys))

    def _prepare(self, batch: TxnBatch, seq: np.ndarray,
                 lane_ids: np.ndarray, ladder: str | None = None):
        """Bucket accounting + vacant-row padding for one batch: pads it
        to its (K, L) bucket and extends ``seq`` / ``lane_ids`` over the
        vacant rows (sequence numbers past every real one).  Returns
        ``(batch, seq, lane_ids, k, bk)`` with k the real row count."""
        k = batch.n_txns
        seq = np.asarray(seq, np.int64)
        lane_ids = np.asarray(lane_ids, np.int64) % max(self.n_lanes, 1)
        bk, bl = self._bucket_shape(batch, ladder)
        self._bucket_counts[(bk, bl)] = \
            self._bucket_counts.get((bk, bl), 0) + 1
        batch = batch.to(self.device)
        if (bk, bl) != (k, batch.max_ins):
            batch = pad_batch(batch, bk, bl)
            base = seq.max() if k else 0
            seq = np.concatenate([seq, base + 1 + np.arange(bk - k)])
            lane_ids = np.concatenate(
                [lane_ids, np.zeros((bk - k,), lane_ids.dtype)])
        return batch, seq, lane_ids, k, bk

    def _record(self, trace: ExecTrace, k: int, bk: int) -> ExecTrace:
        """Slice vacant rows back off and keep the trace (the commit
        order is read from it by replay_log() on demand)."""
        if bk != k:
            trace = dataclasses.replace(trace, **{
                f: getattr(trace, f)[:k] for f in _PER_TXN_FIELDS})
        self._n_txns += k
        self.traces.append(trace)
        return trace

    def _submit_seq(self, batch: TxnBatch, seq: np.ndarray,
                    lane_ids: np.ndarray,
                    ladder: str | None = None) -> ExecTrace:
        """``submit`` with the sequence numbers already assigned: ``seq``
        ranks the rows, ``lane_ids`` are engine-facing lanes."""
        batch, seq, lane_ids, k, bk = self._prepare(batch, seq, lane_ids,
                                                    ladder)
        self.store, trace = self.engine.raw(
            self.store, batch, self._as_dev(seq), self._as_dev(lane_ids),
            self.n_lanes)
        return self._record(trace, k, bk)

    def _as_dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a.astype(np.int32)).to(self.device)

    # ------------------------------------------ cross-batch speculation
    def _spec_enqueue(self, batch: TxnBatch, seq: np.ndarray,
                      lane_ids: np.ndarray,
                      ladder: str | None = None) -> None:
        """Run one batch's round 0 speculatively against the current store
        (only read) and append it to the window."""
        batch, seq, lane_ids, k, bk = self._prepare(batch, seq, lane_ids,
                                                    ladder)
        seed = protocol.spec_execute(self.store, batch)
        self._window.append((batch, seq, lane_ids, seed, k, bk))

    def _spec_drain(self) -> ExecTrace:
        """Execute the window's oldest batch for real: the engine's seeded
        step re-bases its speculation onto the current store."""
        batch, seq, lane_ids, seed, k, bk = self._window.pop(0)
        self.store, trace = self.engine.raw_spec(
            self.store, batch, self._as_dev(seq), self._as_dev(lane_ids),
            self.n_lanes, seed)
        return self._record(trace, k, bk)

    def _spec_flush(self) -> list[ExecTrace]:
        """Drain the whole window (stream end, or before a submit)."""
        out = []
        while self._window:
            out.append(self._spec_drain())
        return out

    def _enqueue_and_drain(self, batch, seq, lane_ids,
                           ladder: str | None = None) -> list[ExecTrace]:
        """Enqueue one batch, then drain while the window holds more than
        ``pipeline_depth``; returns the traces completed (none while the
        window fills)."""
        self._spec_enqueue(batch, seq, lane_ids, ladder)
        out = []
        while len(self._window) > self.pipeline_depth:
            out.append(self._spec_drain())
        return out

    def _serve_formed(self, fb, ladder: str | None = None
                      ) -> list[ExecTrace]:
        """Execute one ingress-formed batch (the unit step of ``serve`` and
        of the replica loop in ``repro_torch.core.checkpoint``): advance
        the elastic lane manager to this formed-batch boundary and map
        client lanes onto live worker lanes, bump the formed-batch
        cursor, then submit at the pool's sequence numbers, through the
        speculation window when pipelined.  Returns the traces this step
        completed."""
        fb_ladder = ladder if ladder is not None else fb.ladder
        lanes = fb.lanes
        if self.elastic is not None:
            self.elastic.advance_to(self._batches_formed + 1)
            lanes = np.asarray([self.elastic.worker_for(int(l))
                                for l in np.asarray(fb.lanes)], np.int64)
        self._batches_formed += 1
        if self._pipelined:
            return self._enqueue_and_drain(fb.batch, fb.seq, lanes,
                                           fb_ladder)
        return [self._submit_seq(fb.batch, fb.seq, lanes, ladder=fb_ladder)]

    def serve(self, pool, budget: int = 64, *,
              max_batches: int | None = None, ladder: str | None = None,
              elastic=None) -> list[ExecTrace]:
        """Drain an :class:`~repro_torch.core.ingress.IngressPool` through
        the session until it is empty (or ``max_batches`` were formed).

        Each step forms the next batch (``pool.drain(budget)``) and
        executes it at the pool's sequence numbers; the (K, L) bucket
        follows the pool's ladder recommendation unless ``ladder`` pins
        one.  Replicas serving pools fed one arrival journal commit the
        same stores and ``replay_log()`` for any budget schedules that
        drain the same prefix, and for any ``pipeline_depth`` (the window
        is flushed before returning).  ``elastic`` attaches an
        :class:`~repro_torch.runtime.elastic.ElasticLaneManager` (see
        ``_serve_formed``)."""
        if elastic is not None:
            self.elastic = elastic
        traces: list[ExecTrace] = []
        formed = 0
        while max_batches is None or formed < max_batches:
            fb = pool.drain(budget)
            if fb is None:
                break
            formed += 1
            traces.extend(self._serve_formed(fb, ladder=ladder))
        traces.extend(self._spec_flush())
        return traces

    def run_stream(self, batches: Iterable[TxnBatch],
                   lanes: Sequence[Sequence] | None = None
                   ) -> list[ExecTrace]:
        """Submit a whole (possibly ragged) stream of batches; returns one
        trace each, in submission order.  With ``pipeline_depth=D >= 1``
        each batch speculates against the store at enqueue time and the
        window drains once it holds more than D."""
        batches = list(batches)
        lanes_list = list(lanes) if lanes is not None \
            else [None] * len(batches)
        if len(lanes_list) != len(batches):
            raise ValueError(
                f"{len(batches)} batches but {len(lanes_list)} lane lists")
        if not self._pipelined:
            return [self.submit(b, l) for b, l in zip(batches, lanes_list)]
        traces: list[ExecTrace] = []
        for b, l in zip(batches, lanes_list):
            k = b.n_txns
            keys = list(l) if l is not None else [0] * k
            if len(keys) != k:
                raise ValueError(
                    f"batch has {k} txns, got {len(keys)} lanes")
            seq = np.asarray(self.sequencer.order_for(keys), np.int64)
            traces.extend(self._enqueue_and_drain(b, seq,
                                                  self._lane_ids(keys)))
        traces.extend(self._spec_flush())
        return traces

    # --------------------------------------------------- crash recovery
    def snapshot(self, directory: str, *, pool=None,
                 _torn_hook=None) -> str:
        """Commit one crash-consistent snapshot of this session (and the
        ingress ``pool`` feeding it) under ``directory``, the speculation
        window flushed first; returns the snapshot's path.  See
        :func:`repro_torch.core.checkpoint.save_snapshot`."""
        from repro_torch.core import checkpoint
        return checkpoint.save_snapshot(self, directory, pool=pool,
                                        _torn_hook=_torn_hook)

    @classmethod
    def restore(cls, directory: str, **overrides
                ) -> "tuple[PotSession, object]":
        """Rebuild ``(session, pool)`` from the newest complete snapshot
        under ``directory``, verified before it serves.  Keyword
        overrides (``step=``, ``arrival_journal=``, ``shards=``,
        ``engine=``, ``pipeline_depth=``, ``device=``, ...) pass through
        to :func:`repro_torch.core.checkpoint.restore_session`."""
        from repro_torch.core import checkpoint
        return checkpoint.restore_session(directory, **overrides)

    def _lane_ids(self, keys) -> np.ndarray:
        """Engine-facing lane array: numeric keys mod n_lanes; symbolic
        sequencing keys map to lane 0."""
        try:
            ids = np.asarray(keys, dtype=np.int64)
        except (TypeError, ValueError):
            return np.zeros((len(keys),), np.int64)
        return ids % max(self.n_lanes, 1)

    # ------------------------------------------------------ introspection
    @property
    def n_txns(self) -> int:
        """Transactions submitted to this session so far."""
        return self._n_txns

    @property
    def gv(self) -> int:
        """Global version = sequence number of the last commit."""
        return int(self.store.gv)

    @property
    def batches_formed(self) -> int:
        """Ingress-formed batches executed (or enqueued) by this session:
        the cursor a restored replica re-enters its schedules at."""
        return self._batches_formed

    @property
    def recovery_batches(self) -> int:
        """Batches executed since restoring from a snapshot (0 for a
        session that never restored)."""
        return len(self.traces) if self.restored_from >= 0 else 0

    def fingerprint(self) -> int:
        """Order-sensitive hash of the committed store image."""
        return store_fingerprint(self.store)

    def compile_count(self) -> int:
        """Distinct (K, L) step shapes this session has run: the
        reference's count of compiled steps.  PyTorch compiles nothing per
        shape, so here it counts the buckets the kernels saw."""
        return len(self._bucket_counts)

    def bucket_counts(self) -> dict[tuple[int, int], int]:
        """Batches submitted per (K, L) step-shape bucket."""
        return dict(self._bucket_counts)

    def replay_log(self) -> list[int]:
        """Global commit order across the whole stream: entry i is the
        global txn id (batch offset + index) that committed i-th.  Rows
        with ``commit_pos < 0`` (vacant or uncommitted) are skipped."""
        for trace in self.traces[self._log_batches:]:
            # ids offset by the txns of all prior batches (not by log
            # length: a batch can log fewer entries than its k)
            offset = self._log_txns
            cp = trace.commit_pos.cpu().numpy()
            order = np.argsort(cp, kind="stable")
            order = order[cp[order] >= 0]
            self._log.extend(int(t) + offset for t in order)
            self._log_batches += 1
            self._log_txns += trace.n_txns
        return list(self._log)

    def live_counts(self) -> list[np.ndarray]:
        """Per-round live (re-executed) transaction counts, one array per
        submitted batch, trimmed to the rounds each batch ran."""
        return [t.live_counts() for t in self.traces]

    def wave_counts(self) -> list[np.ndarray]:
        """Per-round retry-wave counts, one array per submitted batch
        (DeSTM's; empty for the engines that record none)."""
        return [t.wave_counts() for t in self.traces]

    def replay_sequencer(self) -> ReplaySequencer:
        """A sequencer that replays this session's commit order — feed it
        to a fresh ``PotSession`` with the same batches (paper §2.1)."""
        return ReplaySequencer(self.replay_log())
