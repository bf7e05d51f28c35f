"""Deterministic replica failover in the port under injected faults
(after tests/test_failover.py).

  F1  FaultPlan is validated and fires only at its (batch, phase) point.
  F2  A replica killed at a fault point (mid-snapshot with a torn staging
      directory included) restores from its latest complete snapshot and
      the arrival journal's suffix, and ends bitwise equal to an
      uninterrupted replica: fingerprint, replay_log() and the trace
      digests of the batches it ran.  In-process ("raise") over the
      reference's tier-1 subset of engines x shards x depths x budget
      schedules, and once as a real SIGKILL of
      ``python -m repro_torch.core.checkpoint`` with ``"device": "cpu"``.
  F3  Elastic failover: a replica restored across join/leave events
      numbers lanes as the uninterrupted one; ``serve(elastic=)``.
  F4  The metrics CSV carries snapshots_taken / restored_from /
      recovery_batches.
  F5  A replica of the reference killed mid-stream is resumed by the
      port from the reference's snapshots, and ends equal to the
      reference's uninterrupted replica.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.core import IngressPool as RefPool
from repro.core import FaultInjected as RefFaultInjected
from repro.core import FaultPlan as RefFaultPlan
from repro.core import run_replica as ref_run_replica
from repro.core import trace_digest as ref_trace_digest
from repro.core import workloads as ref_W
from repro.core.ingress import programs_from_batch as ref_programs
from repro_torch.core import (FaultInjected, FaultPlan, IngressPool,
                              PotSession, run_replica, trace_digest)
from repro_torch.core import metrics as M
from repro_torch.core import workloads as W
from repro_torch.core.checkpoint import snapshot_ids
from repro_torch.core.ingress import programs_from_batch
from repro_torch.core.txn import run_all
from repro_torch.core.tstore import make_store
from repro_torch.runtime.elastic import ElasticLaneManager, ScalingEvent

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_OBJECTS = 64
N_LANES = 6


def _journal(pool_cls, programs, workloads, **kw):
    wl = workloads.counters(n_txns=60, n_objects=N_OBJECTS, n_reads=2,
                            n_writes=2, n_lanes=N_LANES, skew=0.7, seed=3,
                            **kw)
    pool = pool_cls(capacity=512)
    for i, p in enumerate(programs(wl.batch)):
        pool.admit(p, lane=i % N_LANES, fee=i % 5)
    return pool.arrival_journal()


JOURNAL = _journal(IngressPool, programs_from_batch, W, device="cpu")


def _assert_recovered(rec_fp, rec_log, rec_digests, base,
                      digest=trace_digest):
    assert rec_fp == base.session.fingerprint()
    assert rec_log == base.session.replay_log()
    bd = [digest(t) for t in base.session.traces]
    assert rec_digests == bd[len(bd) - len(rec_digests):]


def _recovered(rec, base, digest=trace_digest):
    _assert_recovered(rec.session.fingerprint(), rec.session.replay_log(),
                      [trace_digest(t) for t in rec.session.traces], base,
                      digest)


# ------------------------------------------------------------- F1 plans
def test_fault_plan_validates_its_schedule():
    with pytest.raises(ValueError, match="phase"):
        FaultPlan(kill_batch=1, kill_phase="commit")
    with pytest.raises(ValueError, match="action"):
        FaultPlan(kill_batch=1, action="explode")
    with pytest.raises(ValueError, match="torn"):
        FaultPlan(kill_batch=1, kill_phase="execute", torn=True)


def test_fault_plan_fires_only_at_its_point():
    plan = FaultPlan(kill_batch=2, kill_phase="drain", action="raise")
    plan.fire(0, "drain")
    plan.fire(2, "execute")
    assert not plan.matches(1, "drain") and plan.matches(2, "drain")
    with pytest.raises(FaultInjected, match="batch 2, phase 'drain'"):
        plan.fire(2, "drain")
    FaultPlan().fire(0, "drain")     # the empty plan never fires


# -------------------------------------------------- F2 kill-and-restore
# the reference's tier-1 subset: both engines, both layouts, both depths,
# both schedules, a torn and a plain phase
TIER1 = [("pcc", 1, 0, (7, 11), 4, "drain", False),
         ("occ", 8, 2, (16,), 4, "snapshot", True),
         ("pcc", 8, 2, (16,), 4, "snapshot", False),
         ("occ", 1, 0, (7, 11), 4, "execute", False)]


@pytest.mark.parametrize("engine,shards,depth,budgets,kill,phase,torn",
                         TIER1)
def test_kill_and_restore_in_process(tmp_path, engine, shards, depth,
                                     budgets, kill, phase, torn):
    kw = dict(n_objects=N_OBJECTS, engine=engine, n_lanes=N_LANES,
              shards=shards, pipeline_depth=depth, budgets=budgets,
              device="cpu")
    base = run_replica(JOURNAL, directory=str(tmp_path / "base"),
                       snapshot_every=0, **kw)
    vdir = str(tmp_path / "victim")
    plan = FaultPlan(kill_batch=kill, kill_phase=phase, torn=torn,
                     action="raise")
    with pytest.raises(FaultInjected):
        run_replica(JOURNAL, directory=vdir, snapshot_every=2,
                    fault_plan=plan, **kw)
    rec = run_replica(JOURNAL, directory=vdir, snapshot_every=2,
                      resume=True, **kw)
    assert rec.session.restored_from >= 0
    assert rec.session.store.layout.shards == shards
    _recovered(rec, base)


def test_torn_snapshot_leaves_latest_complete_invariant(tmp_path):
    kw = dict(n_objects=N_OBJECTS, engine="pcc", n_lanes=N_LANES,
              budgets=(7, 11), device="cpu")
    vdir = str(tmp_path / "victim")
    plan = FaultPlan(kill_batch=4, kill_phase="snapshot", torn=True,
                     action="raise")
    with pytest.raises(FaultInjected):
        run_replica(JOURNAL, directory=vdir, snapshot_every=2,
                    fault_plan=plan, **kw)
    assert snapshot_ids(vdir) == [0]
    assert any("tmp" in name for name in os.listdir(vdir))
    base = run_replica(JOURNAL, directory=str(tmp_path / "base"),
                       snapshot_every=0, **kw)
    rec = run_replica(JOURNAL, directory=vdir, snapshot_every=2,
                      resume=True, **kw)
    assert rec.session.restored_from == 0
    _recovered(rec, base)


def test_kill_before_any_snapshot_cold_starts(tmp_path):
    kw = dict(n_objects=N_OBJECTS, engine="pcc", n_lanes=N_LANES,
              budgets=(7, 11), device="cpu")
    vdir = str(tmp_path / "victim")
    plan = FaultPlan(kill_batch=0, kill_phase="admit", action="raise")
    with pytest.raises(FaultInjected):
        run_replica(JOURNAL, directory=vdir, snapshot_every=2,
                    fault_plan=plan, **kw)
    assert snapshot_ids(vdir) == []
    base = run_replica(JOURNAL, directory=str(tmp_path / "base"),
                       snapshot_every=0, **kw)
    rec = run_replica(JOURNAL, directory=vdir, snapshot_every=2,
                      resume=True, **kw)
    assert rec.session.restored_from == -1      # never restored: cold
    _recovered(rec, base)


def _run_replica_process(cfg, cfg_path, out_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.core.checkpoint",
         str(cfg_path), str(out_path)],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=300)


def test_sigkill_and_restore_subprocess(tmp_path):
    """A real SIGKILL at the fault point (after tearing the staged
    snapshot mid-commit); a fresh process restores and reconverges."""
    kw = dict(n_objects=N_OBJECTS, engine="occ", n_lanes=N_LANES,
              shards=8, pipeline_depth=2, budgets=[16], device="cpu")
    base = run_replica(JOURNAL, directory=str(tmp_path / "base"),
                       snapshot_every=0, **kw)
    vdir = str(tmp_path / "victim")
    cfg_path, out_path = tmp_path / "cfg.json", tmp_path / "out.json"
    victim = dict(kw, journal=JOURNAL, directory=vdir, snapshot_every=2,
                  fault={"kill_batch": 4, "kill_phase": "snapshot",
                         "torn": True})
    r = _run_replica_process(victim, cfg_path, out_path)
    assert r.returncode == -9, (r.returncode, r.stderr[-2000:])
    assert not out_path.exists()
    assert snapshot_ids(vdir) == [0]
    recovery = dict(kw, journal=JOURNAL, directory=vdir, snapshot_every=2,
                    resume=True)
    r = _run_replica_process(recovery, cfg_path, out_path)
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(out_path.read_text())
    assert out["pool_depth"] == 0 and out["restored_from"] == 0
    _assert_recovered(out["fingerprint"], out["replay_log"],
                      out["trace_digests"], base)


# ------------------------------------------------- F3 elastic failover
ELASTIC_EVENTS = [[2, "join", None, 0], [5, "leave", 2, 0]]


def test_elastic_failover_numbers_lanes_identically(tmp_path):
    """DeSTM's lane placement decides round membership: a restored
    replica must number lanes as the victim did across the events."""
    kw = dict(n_objects=N_OBJECTS, engine="destm", n_lanes=4,
              budgets=(7, 11), elastic_events=ELASTIC_EVENTS, device="cpu")
    base = run_replica(JOURNAL, directory=str(tmp_path / "base"),
                       snapshot_every=0, **kw)
    assert base.session.elastic is not None
    vdir = str(tmp_path / "victim")
    plan = FaultPlan(kill_batch=4, kill_phase="execute", action="raise")
    with pytest.raises(FaultInjected):
        run_replica(JOURNAL, directory=vdir, snapshot_every=2,
                    fault_plan=plan, **kw)
    rec = run_replica(JOURNAL, directory=vdir, snapshot_every=2,
                      resume=True, **kw)
    assert rec.session.elastic.state_dict() == \
        base.session.elastic.state_dict()
    assert rec.session.elastic.live_lanes() == \
        base.session.elastic.live_lanes()
    _recovered(rec, base)


def test_serve_accepts_elastic_manager():
    pool, _ = IngressPool.replay(JOURNAL)
    mgr = ElasticLaneManager(4, [ScalingEvent(2, "join", None, 0)])
    s = PotSession(N_OBJECTS, engine="pcc", n_lanes=4, device="cpu")
    s.serve(pool, budget=9, elastic=mgr)
    assert s.elastic is mgr and s.batches_formed > 2
    assert mgr._round == s.batches_formed
    assert 4 in mgr.live_lanes()
    pool2, _ = IngressPool.replay(JOURNAL)
    s2 = PotSession(N_OBJECTS, engine="pcc", n_lanes=4, device="cpu")
    s2.serve(pool2, budget=9,
             elastic=ElasticLaneManager(4, [ScalingEvent(2, "join", None,
                                                         0)]))
    assert s2.fingerprint() == s.fingerprint()
    assert s2.replay_log() == s.replay_log()


# ------------------------------------------------- F4 metrics columns
def test_metrics_csv_carries_failover_observables(tmp_path):
    kw = dict(n_objects=N_OBJECTS, engine="pcc", n_lanes=N_LANES,
              budgets=(7, 11), device="cpu")
    run_replica(JOURNAL, directory=str(tmp_path), snapshot_every=2, **kw)
    rec = run_replica(JOURNAL, directory=str(tmp_path), snapshot_every=2,
                      resume=True, **kw)
    session, pool = rec.session, rec.pool
    wl = W.counters(n_txns=12, n_objects=N_OBJECTS, n_lanes=4, seed=4,
                    device="cpu")
    trace = session.submit(wl.batch, wl.lanes.tolist())
    res = run_all(wl.batch, make_store(N_OBJECTS, device="cpu").values)
    rep = M.report_from_trace("pcc", trace, wl.batch, res.rn.numpy(),
                              res.wn.numpy(), session=session, pool=pool)
    assert rep.snapshots_taken == session.snapshots_taken >= 1
    assert rep.restored_from == session.restored_from >= 0
    assert rep.recovery_batches == session.recovery_batches >= 1
    header = M.HEADER.split(",")
    assert len(rep.row().split(",")) == len(header)
    for col in ("snapshots_taken", "restored_from", "recovery_batches"):
        assert col in header
    fresh = M.report_from_trace(
        "pcc", trace, wl.batch, res.rn.numpy(), res.wn.numpy(),
        session=PotSession(N_OBJECTS, device="cpu"))
    assert (fresh.snapshots_taken, fresh.restored_from,
            fresh.recovery_batches) == (0, -1, 0)


# ------------------------------------------- F5 across the packages
def test_port_resumes_a_killed_reference_replica(tmp_path):
    ref_journal = _journal(RefPool, ref_programs, ref_W)
    kw = dict(n_objects=N_OBJECTS, engine="pcc", n_lanes=N_LANES,
              shards=8, budgets=(7, 11))
    base = ref_run_replica(ref_journal, directory=str(tmp_path / "base"),
                           snapshot_every=0, **kw)
    vdir = str(tmp_path / "victim")
    with pytest.raises(RefFaultInjected):
        ref_run_replica(ref_journal, directory=vdir, snapshot_every=2,
                        fault_plan=RefFaultPlan(kill_batch=3,
                                                kill_phase="execute",
                                                action="raise"), **kw)
    rec = run_replica(JOURNAL, directory=vdir, snapshot_every=2,
                      resume=True, device="cpu", **kw)
    assert rec.session.restored_from == 0
    _recovered(rec, base, digest=ref_trace_digest)
    assert np.array_equal(
        np.asarray(rec.session.replay_log()),
        np.asarray(base.session.replay_log()))
