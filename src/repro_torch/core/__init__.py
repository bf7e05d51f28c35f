"""Pot core on PyTorch: preordered transactions for deterministic
execution (the port of ``repro.core``).

A sequencer fixes the serialization order before execution, then an
engine executes each batch against the store: ``"pcc"`` (Pot, alias
``"pot"``), ``"pogl"`` (the serial oracle), ``"destm"`` (one transaction
per lane per round, wave retries) or ``"occ"`` (traditional OCC, whose
outcome depends on the arrival order; the other three depend only on the
sequence order)::

    session = PotSession(n_objects=1024, engine="pcc", n_lanes=8,
                         device="cuda")
    traces = session.run_stream(batches, lanes)
    session.fingerprint(), session.replay_log()

``PotSession(..., pipeline_depth=D)`` speculates up to D batches ahead
of the committed store with the same outcome, and ``serve(pool)`` drains
an ``IngressPool`` that forms batches from single-transaction arrivals.
``PotSession(..., shards=S)`` cuts the store into S contiguous range
shards (``ShardedStore``) with the dense store's outcome.
``session.snapshot(dir, pool=...)`` / ``PotSession.restore(dir, ...)``
and ``run_replica`` give crash-consistent snapshots and deterministic
replica failover under injected faults (``FaultPlan``): restoring the
latest snapshot and draining the arrival journal's suffix equals the
uninterrupted stream bit for bit.  Not ported: ``mesh`` (one shard per
device).

Building blocks: ``TStore`` / ``ShardedStore`` / ``StoreLayout`` /
``make_store`` / ``shard_store`` / ``unshard_store`` / ``fingerprint``,
``TxnBatch`` / ``make_batch`` and the VM (``run_all``, ``run_live``,
``run_live_compact``), the sequencers, ``get_engine`` / ``ExecTrace``,
``SpecSeed`` (a speculative round 0), ``metrics.report_from_trace``.
"""

from repro_torch.core.checkpoint import (FaultInjected, FaultPlan,
                                         ReplicaRun, SnapshotError,
                                         atomic_dir, latest_snapshot,
                                         load_snapshot, restore_session,
                                         run_replica, save_snapshot,
                                         trace_digest)
from repro_torch.core.engine import (ENGINES, MODE_FAST, MODE_PREFIX,
                                     MODE_SPEC, MODE_UNSET, Engine,
                                     EngineDef, ExecTrace, get_engine,
                                     make_trace)
from repro_torch.core.destm import DestmTrace, destm_execute
from repro_torch.core.ingress import (AdmitResult, FormedBatch,
                                      IngressPool, JournalError, PoolStats,
                                      programs_from_batch)
from repro_torch.core.metrics import EngineReport, report_from_trace
from repro_torch.core.occ import OccTrace, occ_execute
from repro_torch.core.pcc import PccTrace, pcc_execute
from repro_torch.core.pogl import pogl_execute
from repro_torch.core.protocol import SpecSeed
from repro_torch.core.sequencer import (ExplicitSequencer, ReplaySequencer,
                                        RoundRobinSequencer, seq_to_order,
                                        sequencer_from_state,
                                        sequencer_state)
from repro_torch.core.session import PotSession
from repro_torch.core.tstore import (DenseStore, ShardedStore, StoreLayout,
                                     TStore, dense_image, fingerprint,
                                     make_store, shard_store, store_with,
                                     unshard_store)
from repro_torch.core.txn import (NOP, READ, RMW, WRITE, TxnBatch,
                                  TxnResult, make_batch, next_pow2,
                                  pad_batch, run_all, run_live,
                                  run_live_compact, run_txn)

__all__ = [
    "PotSession", "ExecTrace", "Engine", "EngineDef", "ENGINES",
    "get_engine", "make_trace",
    "MODE_UNSET", "MODE_FAST", "MODE_PREFIX", "MODE_SPEC",
    "TStore", "DenseStore", "ShardedStore", "StoreLayout", "make_store",
    "shard_store", "unshard_store", "store_with", "dense_image",
    "fingerprint",
    "TxnBatch", "TxnResult", "make_batch", "run_all", "run_live",
    "run_live_compact", "run_txn", "pad_batch", "next_pow2",
    "NOP", "READ", "WRITE", "RMW",
    "RoundRobinSequencer", "ReplaySequencer", "ExplicitSequencer",
    "seq_to_order", "sequencer_state", "sequencer_from_state",
    "IngressPool", "FormedBatch", "AdmitResult", "PoolStats",
    "programs_from_batch", "JournalError",
    "SnapshotError", "atomic_dir", "save_snapshot", "load_snapshot",
    "latest_snapshot", "restore_session", "run_replica", "ReplicaRun",
    "FaultPlan", "FaultInjected", "trace_digest",
    "SpecSeed", "EngineReport", "report_from_trace",
    "pcc_execute", "PccTrace", "occ_execute", "OccTrace",
    "pogl_execute", "destm_execute", "DestmTrace",
]
