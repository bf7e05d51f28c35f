"""PotSession — the streaming execution layer (after
``repro.core.session``), serial path.

A session owns the store (carried across batches, with ``gv``), the
sequencer (globally increasing sequence numbers) and its engine, all on
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

Not ported yet (they raise ``NotImplementedError``): cross-batch
pipelining (``pipeline_depth > 0``), the sharded store (``shards > 1``,
``mesh``), elastic lanes, ingress serving (``serve``) and snapshots.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np
import torch

from repro_torch.core.engine import EngineDef, ExecTrace, get_engine
from repro_torch.core.sequencer import ReplaySequencer, RoundRobinSequencer
from repro_torch.core.tstore import TStore, make_store
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


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (see ROADMAP.md queue 1)")


class PotSession:
    """Deterministic transactional execution over a stream of batches.

    Args:
      n_objects: size of a fresh store (ignored if ``store`` is given).
      slot / init: forwarded to :func:`make_store` for the fresh store.
      store: an existing TStore to adopt (moved to ``device``).
      engine: engine name (``"pcc"``, or its alias ``"pot"``) or an
        :class:`~repro_torch.core.engine.EngineDef`.
      sequencer: any object with ``order_for(keys) -> (K,) seq numbers``;
        defaults to a ``RoundRobinSequencer`` over ``n_lanes`` lanes.
      n_lanes: lane count (round-robin width).
      bucket: pad batch shapes up to buckets with vacant NOP rows
        (bit-identical outcome); False submits exact shapes.
      bucket_ladder: ``"pow2"`` (next power of two) or ``"dense"``
        ({1, 2, 4, 8} ∪ multiples of 8) for the K axis; L always
        buckets to powers of two.
      device: where the store lives and the engine runs (``"cuda"`` by
        default; ``"cpu"`` takes the scatter-min formulation).
      shards, mesh, pipeline_depth, elastic: only their serial, dense
        defaults are supported.
    """

    def __init__(self, n_objects: int | None = None, *, slot: int = 1,
                 init=None, store: TStore | None = None,
                 engine: str | EngineDef = "pcc", sequencer=None,
                 n_lanes: int = 1, bucket: bool = True,
                 bucket_ladder: str = "pow2", shards: int = 1, mesh=None,
                 pipeline_depth: int = 0, elastic=None, device="cuda"):
        if shards != 1 or mesh is not None:
            raise _not_ported("the sharded store (shards > 1, mesh)")
        if pipeline_depth < 0:
            raise ValueError("pipeline_depth must be >= 0")
        if pipeline_depth > 0:
            raise _not_ported("cross-batch pipelining (pipeline_depth > 0)")
        if elastic is not None:
            raise _not_ported("elastic lane management")
        if bucket_ladder not in ("pow2", "dense"):
            raise ValueError(
                f"bucket_ladder must be 'pow2' or 'dense', "
                f"got {bucket_ladder!r}")
        self.device = torch.device(device)
        if store is None:
            if n_objects is None:
                raise ValueError("PotSession needs n_objects or store")
            store = make_store(n_objects, slot=slot, init=init,
                               device=self.device)
        else:
            store = TStore(store.values.to(self.device),
                           store.versions.to(self.device),
                           store.gv.to(self.device))
        self.bucket_ladder = bucket_ladder
        self.store = store
        self.engine = engine if isinstance(engine, EngineDef) \
            else get_engine(engine)
        self.n_lanes = n_lanes
        self.sequencer = sequencer if sequencer is not None \
            else RoundRobinSequencer(n_root_lanes=n_lanes)
        self.bucket = bucket
        self.traces: list[ExecTrace] = []
        # replay log cache, materialized lazily in replay_log()
        self._log: list[int] = []
        self._log_batches = 0      # traces already folded into _log
        self._log_txns = 0         # Σ n_txns of those traces (id offset)
        self._n_txns = 0
        self._bucket_counts: dict[tuple[int, int], int] = {}

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
        as_dev = lambda a: torch.from_numpy(a.astype(np.int32)).to(
            self.device)
        self.store, trace = self.engine.raw(
            self.store, batch, as_dev(seq), as_dev(lane_ids), self.n_lanes)
        return self._record(trace, k, bk)

    def run_stream(self, batches: Iterable[TxnBatch],
                   lanes: Sequence[Sequence] | None = None
                   ) -> list[ExecTrace]:
        """Submit a whole (possibly ragged) stream of batches; returns one
        trace each."""
        batches = list(batches)
        lanes_list = list(lanes) if lanes is not None \
            else [None] * len(batches)
        if len(lanes_list) != len(batches):
            raise ValueError(
                f"{len(batches)} batches but {len(lanes_list)} lane lists")
        return [self.submit(b, l) for b, l in zip(batches, lanes_list)]

    def serve(self, pool, budget: int = 64, **kwargs):
        raise _not_ported("ingress serving (PotSession.serve)")

    def snapshot(self, directory: str, **kwargs):
        raise _not_ported("session snapshots")

    @classmethod
    def restore(cls, directory: str, **overrides):
        raise _not_ported("session restore")

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

    def fingerprint(self) -> int:
        """Order-sensitive hash of the committed store image."""
        return store_fingerprint(self.store)

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
        (empty for PCC, which records none)."""
        return [t.wave_counts() for t in self.traces]

    def replay_sequencer(self) -> ReplaySequencer:
        """A sequencer that replays this session's commit order — feed it
        to a fresh ``PotSession`` with the same batches (paper §2.1)."""
        return ReplaySequencer(self.replay_log())
