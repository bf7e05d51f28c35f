"""Structural cost model over engine traces (the port's own copy of
``repro.core.metrics``).  Trace fields and batches are tensors here,
read through ``.cpu()``.

It accounts *instruction-slots*, the deterministic unit the engines
count exactly, and builds the paper's figures from them:

- ``critical_path``: Σ over engine rounds of the most expensive
  transaction executed in that round = parallel makespan with one lane per
  transaction.  PoGL's critical path is the serial sum (global lock).
- ``wait_rounds``: rounds a transaction spent executed-but-not-committed
  (Fig. 9's "time waiting for turn").
- ``work``: total instruction-slots executed including retries
  (speculation waste).
- ``wave_trips`` / ``live_txns``: the engine-loop observables —
  OCC's per-round conflict-chain depth (wave_commit fixpoint trips) and
  the incremental read phase's actual re-execution count.

Speculative instrumentation overhead (read-set tracking, write buffering,
validation) is charged per tracked word, mirroring what the paper's Fig. 6
microbenchmark measures per access.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

SPEC_TRACK_COST = 1.0   # per tracked read/write word (buffering, logging)
VALIDATE_COST = 1.0     # per validated read word


@dataclasses.dataclass
class EngineReport:
    name: str
    rounds: int
    work_ops: float          # total executed instruction slots (w/ retries)
    critical_path: float     # parallel makespan in op-slots
    total_wait_rounds: int
    retries: int
    fast_commits: int        # MODE_FAST commits (head of prefix)
    prefix_commits: int      # simultaneous-fast (promoted) commits
    throughput: float        # txns per critical-path op-slot
    wave_trips: int = 0      # Σ wave_commit fixpoint iterations (OCC):
    #                          contention cost of the commit decision
    live_txns: int = 0       # Σ per-round re-executed (live) txns — the
    #                          incremental loop's actual read-phase work
    walked_slots: int = 0    # Σ per-round executor width × L — device slots
    #                          the read phase walked (C·L per compact
    #                          round vs K·L masked)
    compile_count: int = 0   # distinct compiled step shapes of the session
    #                          behind this trace (bucketed streaming: <=
    #                          ladder size; 0 when no session was given)
    # -- ingress observables: filled when a pool= is given -------------
    queue_depth: int = 0     # transactions still parked in the pool
    admitted: int = 0        # pool admissions accepted so far
    evicted: int = 0         # watermark evictions so far
    drained: int = 0         # transactions formed into batches so far
    backpressure: int = 0    # 1 when the pool's backpressure signal is up
    # -- cross-batch speculation observables: nonzero only for batches
    #    executed through a pipelined session ------------------------
    spec_executed: int = 0   # rows executed against the pre-state snapshot
    spec_invalidated: int = 0  # speculated rows re-executed (stale reads)
    spec_rounds: int = 0     # revalidation re-execution passes (0 or 1)
    pipeline_depth: int = 0  # the session's speculation window depth
    # -- failover observables: filled from the session ----------------
    snapshots_taken: int = 0   # crash-consistent snapshots committed
    restored_from: int = -1    # snapshot id the session restored from
    #                            (-1: never restored)
    recovery_batches: int = 0  # batches executed since the restore
    # -- DeSTM retry-wave observables ---------------------------------
    retry_waves: int = 0     # Σ token-walk trips that re-executed ≥ 1
    #                          member (wave mode: ≤ retries; serial
    #                          walk: == retry events)
    spec_engine: int = 0     # 1 when the engine behind the trace has a
    #                          seeded entry point (raw_spec) — i.e. it
    #                          can serve a pipelined session

    def row(self) -> str:
        return (f"{self.name},{self.rounds},{self.work_ops:.0f},"
                f"{self.critical_path:.0f},{self.total_wait_rounds},"
                f"{self.retries},{self.fast_commits},{self.prefix_commits},"
                f"{self.throughput:.5f},{self.wave_trips},{self.live_txns},"
                f"{self.walked_slots},{self.compile_count},"
                f"{self.queue_depth},{self.admitted},{self.evicted},"
                f"{self.drained},{self.backpressure},{self.spec_executed},"
                f"{self.spec_invalidated},{self.spec_rounds},"
                f"{self.pipeline_depth},{self.snapshots_taken},"
                f"{self.restored_from},{self.recovery_batches},"
                f"{self.retry_waves},{self.spec_engine}")


HEADER = ("engine,rounds,work_ops,critical_path,wait_rounds,retries,"
          "fast_commits,prefix_commits,throughput,wave_trips,live_txns,"
          "walked_slots,compile_count,queue_depth,admitted,evicted,"
          "drained,backpressure,spec_executed,spec_invalidated,"
          "spec_rounds,pipeline_depth,snapshots_taken,restored_from,"
          "recovery_batches,retry_waves,spec_engine")


def _np(a) -> np.ndarray:
    """A tensor (on any device) or array-like as a numpy array."""
    if isinstance(a, torch.Tensor):
        return a.cpu().numpy()
    return np.asarray(a)


def _txn_cost(n_ins, rn, wn, fast: bool) -> np.ndarray:
    base = _np(n_ins).astype(np.float64)
    if fast:
        return base  # direct reads/writes, no tracking, no validation
    return base + SPEC_TRACK_COST * (_np(rn) + _np(wn)) \
        + VALIDATE_COST * _np(rn)


def report_from_trace(name: str, trace, batch, res_rn, res_wn,
                      n_lanes: int = 1, session=None,
                      pool=None) -> EngineReport:
    """Build an EngineReport from the canonical ExecTrace of any engine.

    ``name`` picks the engine's cost structure ("pot"/"pcc", "pogl",
    "destm", "occ") — the *schema* is shared, the cost model is not:
    e.g. only Pot has an uninstrumented fast path, only DeSTM pays round
    barriers.

    ``session`` optionally attaches the PotSession the trace came from,
    filling the CSV's compile-cache columns (``compile_count`` — the
    shape-bucketing observable; see PotSession.compile_count()).

    ``pool`` optionally attaches the IngressPool that formed the batch,
    filling the ingress columns (queue depth, admitted/evicted/drained
    counters and the backpressure signal — see
    ``IngressPool.observables()``).
    """
    kind = {"pot": "pot", "pcc": "pot"}.get(name, name)
    if kind == "pot":
        rep = _report_pot(trace, batch, res_rn, res_wn)
    elif kind == "pogl":
        rep = _report_pogl(batch, res_rn, res_wn)
    elif kind == "destm":
        rep = _report_destm(trace, batch, res_rn, res_wn, n_lanes)
    elif kind == "occ":
        rep = _report_occ(trace, batch, res_rn, res_wn)
    else:
        raise KeyError(f"no report model for engine {name!r}")
    if trace is not None:
        rep.walked_slots = int(trace.walked_slots)
        # speculation observables (zero for serial runs, whose
        # make_trace defaults them)
        rep.spec_executed = int(trace.spec_executed)
        rep.spec_invalidated = int(trace.spec_invalidated)
        rep.spec_rounds = int(trace.spec_rounds)
        # retry-wave observable (zero for engines without a token-walk
        # retry loop)
        rep.retry_waves = int(trace.retry_waves)
    if session is not None:
        eng = getattr(session, "engine", None)
        rep.spec_engine = int(getattr(eng, "raw_spec", None) is not None)
        rep.compile_count = session.compile_count()
        rep.pipeline_depth = int(getattr(session, "pipeline_depth", 0))
        # failover observables (defaulted for sessions without them)
        rep.snapshots_taken = int(getattr(session, "snapshots_taken", 0))
        rep.restored_from = int(getattr(session, "restored_from", -1))
        rep.recovery_batches = int(getattr(session, "recovery_batches", 0))
    if pool is not None:
        obs = pool.observables()
        rep.queue_depth = obs["queue_depth"]
        rep.admitted = obs["admitted"]
        rep.evicted = obs["evicted"]
        rep.drained = obs["drained"]
        rep.backpressure = obs["backpressure"]
    return rep


def _report_pot(trace, batch, res_rn, res_wn) -> EngineReport:
    from repro_torch.core.engine import MODE_FAST, MODE_PREFIX
    n_ins = _np(batch.n_ins)
    commit_round = _np(trace.commit_round)
    first_round = _np(trace.first_round)
    mode = _np(trace.mode)
    rounds = int(trace.rounds)
    fast = mode == MODE_FAST
    cost_final = _txn_cost(n_ins, res_rn, res_wn, fast=False)
    cost_final[fast] = n_ins[fast]  # fast path: uninstrumented
    # executions before the commit round are retries at speculative cost
    retries = _np(trace.retries)
    work = float(np.sum(cost_final + retries *
                        _txn_cost(n_ins, res_rn, res_wn, fast=False)))
    # critical path: per round, max cost among txns executing that round
    cp = 0.0
    for r in range(rounds):
        in_flight = (first_round <= r) & (commit_round >= r)
        if in_flight.any():
            cp += float(np.max(cost_final[in_flight]))
    k = len(n_ins)
    return EngineReport(
        name="pot", rounds=rounds, work_ops=work, critical_path=cp,
        total_wait_rounds=int(np.sum(_np(trace.wait_rounds))),
        retries=int(retries.sum()),
        fast_commits=int(fast.sum()),
        prefix_commits=int((mode == MODE_PREFIX).sum()),
        throughput=k / cp if cp else float("inf"),
        live_txns=int(trace.live_txns))


def _report_pogl(batch, res_rn, res_wn) -> EngineReport:
    n_ins = _np(batch.n_ins).astype(np.float64)
    k = len(n_ins)
    cp = float(n_ins.sum())  # strictly serial, uninstrumented
    return EngineReport(
        name="pogl", rounds=k, work_ops=cp, critical_path=cp,
        total_wait_rounds=0, retries=0, fast_commits=k, prefix_commits=0,
        throughput=k / cp if cp else float("inf"))


def _report_destm(trace, batch, res_rn, res_wn, n_lanes: int) -> EngineReport:
    n_ins = _np(batch.n_ins)
    commit_round = _np(trace.commit_round)
    retries = _np(trace.retries)
    rounds = int(trace.rounds)
    cost = _txn_cost(n_ins, res_rn, res_wn, fast=False)
    # round barrier: parallel first executions (max) + token-serialized
    # re-executions of conflicting members (sum), per DeSTM's round rule.
    cp = 0.0
    wait = 0
    for r in range(rounds):
        sel = commit_round == r
        if sel.any():
            round_cost = float(np.max(cost[sel])) + float(
                np.sum(cost[sel] * retries[sel]))
            cp += round_cost
            # every member waits for the barrier: each non-slowest member
            # idles this round (Fig. 10 start/commit waiting).
            wait += int(np.sum(cost[sel] * (1 + retries[sel]) < round_cost))
    k = len(n_ins)
    return EngineReport(
        name="destm", rounds=rounds, work_ops=float(np.sum(cost * (1 + retries))),
        critical_path=cp, total_wait_rounds=wait, retries=int(retries.sum()),
        fast_commits=0, prefix_commits=0,
        throughput=k / cp if cp else float("inf"),
        live_txns=int(trace.live_txns))


def _report_occ(trace, batch, res_rn, res_wn) -> EngineReport:
    n_ins = _np(batch.n_ins)
    retries = _np(trace.retries)
    waves = int(trace.rounds)
    cost = _txn_cost(n_ins, res_rn, res_wn, fast=False)
    cp = 0.0
    # txn committed in wave = retries (it retried that many waves)
    commit_wave = _np(trace.commit_round)
    for w in range(waves):
        in_flight = commit_wave >= w
        if in_flight.any():
            cp += float(np.max(cost[in_flight]))
    k = len(n_ins)
    return EngineReport(
        name="occ", rounds=waves, work_ops=float(np.sum(cost * (1 + retries))),
        critical_path=cp, total_wait_rounds=0, retries=int(retries.sum()),
        fast_commits=0, prefix_commits=0,
        throughput=k / cp if cp else float("inf"),
        wave_trips=int(trace.wave_trips), live_txns=int(trace.live_txns))
