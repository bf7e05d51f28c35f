"""Crash-consistent session snapshots in the port: the format, the
self-verification, the recovery invariant, and snapshots that cross
between the port and the JAX reference.

Properties (after tests/test_checkpoint.py):
  C1  atomic_dir materializes a directory all or nothing.
  C2  A snapshot proves itself complete before it serves (per-file
      sha256, store fingerprint, chained digest); latest_snapshot falls
      back to the newest that verifies.
  C3  restore(snapshot) + drain(arrival-journal suffix) equals the
      uninterrupted run bit for bit (fingerprints, trace digests,
      replay_log()) at any snapshot point, under other budget schedules,
      across reshards S -> S', bucket-ladder changes and depths, and
      idempotently.
  C4  Sequencer cursors round-trip through a snapshot.
  C5  The on-disk format is the reference's: a snapshot the reference
      writes restores into the port and one the port writes restores
      into the reference, across S = 8 -> S' = 1, with equal
      fingerprints, replay logs and trace digests.  (Chain digests
      differ between writers: np.savez stamps zip times.)
"""

import json
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from _hypothesis_compat import given, settings, st

from repro.core import IngressPool as RefPool
from repro.core import PotSession as RefSession
from repro.core import trace_digest as ref_trace_digest
from repro.core import workloads as ref_W
from repro.core.ingress import programs_from_batch as ref_programs
from repro_torch.core import (IngressPool, PotSession, SnapshotError,
                              latest_snapshot, load_snapshot,
                              restore_session, trace_digest)
from repro_torch.core import workloads as W
from repro_torch.core.checkpoint import (SNAP_FORMAT, atomic_dir,
                                         snapshot_ids)
from repro_torch.core.ingress import programs_from_batch

N_OBJECTS = 64
N_LANES = 6
BUDGETS = (7, 11)


def _journal(pool_cls, programs, workloads, **kw):
    wl = workloads.counters(n_txns=60, n_objects=N_OBJECTS, n_reads=2,
                            n_writes=2, n_lanes=N_LANES, skew=0.7, seed=3,
                            **kw)
    pool = pool_cls(capacity=512)
    for i, p in enumerate(programs(wl.batch)):
        pool.admit(p, lane=i % N_LANES, fee=i % 5)
    return pool.arrival_journal()


JOURNAL = _journal(IngressPool, programs_from_batch, W, device="cpu")


def _session(**kw):
    kw.setdefault("engine", "pcc")
    kw.setdefault("n_lanes", N_LANES)
    return PotSession(N_OBJECTS, device="cpu", **kw)


def _drain_through(session, pool, budgets=BUDGETS):
    """The replica loop's body: budgets indexed by the formed-batch
    cursor, so a restored session re-enters the schedule where the
    snapshot left it."""
    while True:
        fb = pool.drain(budgets[session.batches_formed % len(budgets)])
        if fb is None:
            break
        session._serve_formed(fb)
    session._spec_flush()
    return session


def _uninterrupted(budgets=BUDGETS, **kw):
    pool, _ = IngressPool.replay(JOURNAL)
    return _drain_through(_session(**kw), pool, budgets)


def _serve(session, pool, n, budgets=BUDGETS):
    for _ in range(n):
        fb = pool.drain(budgets[session.batches_formed % len(budgets)])
        if fb is None:
            break
        session._serve_formed(fb)


def _interrupted(tmp_path, snapshot_after, budgets=BUDGETS, restore_kw=None,
                 **kw):
    """Serve ``snapshot_after`` batches, snapshot, restore into a fresh
    session and finish the stream there."""
    pool, _ = IngressPool.replay(JOURNAL)
    s = _session(**kw)
    _serve(s, pool, snapshot_after, budgets)
    s.snapshot(str(tmp_path), pool=pool)
    s2, p2 = PotSession.restore(str(tmp_path), arrival_journal=JOURNAL,
                                device="cpu", **(restore_kw or {}))
    return _drain_through(s2, p2, budgets)


def _assert_bitwise_equal(restored, baseline, digest=trace_digest):
    assert restored.fingerprint() == baseline.fingerprint()
    assert restored.replay_log() == baseline.replay_log()
    assert restored.gv == baseline.gv
    assert restored.n_txns == baseline.n_txns
    bd = [digest(t) for t in baseline.traces]
    rd = [trace_digest(t) for t in restored.traces]
    assert rd == bd[len(bd) - len(rd):]


# ------------------------------------------------------------- C1 atomic
def test_atomic_dir_commits_all_or_nothing(tmp_path):
    final = str(tmp_path / "out")
    with atomic_dir(final) as tmp:
        with open(os.path.join(tmp, "a.txt"), "w") as f:
            f.write("v1")
    with pytest.raises(RuntimeError, match="boom"):
        with atomic_dir(final) as tmp:
            with open(os.path.join(tmp, "a.txt"), "w") as f:
                f.write("v2")
            raise RuntimeError("boom")
    assert open(os.path.join(final, "a.txt")).read() == "v1"
    assert os.path.isdir(final + ".tmp")
    with atomic_dir(final) as tmp:
        with open(os.path.join(tmp, "a.txt"), "w") as f:
            f.write("v3")
    assert open(os.path.join(final, "a.txt")).read() == "v3"
    assert not os.path.exists(final + ".tmp")


# ---------------------------------------------------- C2 self-verification
def test_snapshot_self_verifies_and_detects_corruption(tmp_path):
    pool, _ = IngressPool.replay(JOURNAL)
    s = _session()
    _serve(s, pool, 2)
    path = s.snapshot(str(tmp_path), pool=pool)
    manifest, values, versions = load_snapshot(path)
    assert manifest["format"] == SNAP_FORMAT and manifest["shards"] == 1
    assert values.dtype == versions.dtype == np.int32
    assert values.shape == (N_OBJECTS, 1) and versions.shape == (N_OBJECTS,)
    store_file = os.path.join(path, "store.npz")
    data = open(store_file, "rb").read()
    with open(store_file, "wb") as f:
        f.write(data[: len(data) // 2])
    with pytest.raises(SnapshotError, match="corrupted"):
        load_snapshot(path)


def test_sharded_snapshot_keeps_one_file_per_shard(tmp_path):
    """A sharded store writes ``shard_{i}.npz`` in the reference's shapes
    (the last shard trimmed of its padding rows)."""
    pool, _ = IngressPool.replay(JOURNAL)
    s = _session(shards=5)           # C = 13: the last shard holds 12
    _serve(s, pool, 2)
    path = s.snapshot(str(tmp_path), pool=pool)
    manifest, values, _ = load_snapshot(path)
    assert manifest["shards"] == 5
    assert sorted(manifest["files"]) == [f"shard_{i}.npz" for i in range(5)]
    with np.load(os.path.join(path, "shard_4.npz")) as data:
        assert data["values"].shape == (12, 1)
        assert data["versions"].dtype == np.int32
    assert values.shape == (N_OBJECTS, 1)


def test_latest_snapshot_falls_back_past_corruption(tmp_path):
    pool, _ = IngressPool.replay(JOURNAL)
    s = _session()
    _serve(s, pool, 1)
    p0 = s.snapshot(str(tmp_path), pool=pool)
    _serve(s, pool, 1)
    p1 = s.snapshot(str(tmp_path), pool=pool)
    assert snapshot_ids(str(tmp_path)) == [0, 1]
    assert latest_snapshot(str(tmp_path)) == p1
    os.remove(os.path.join(p1, "store.npz"))
    assert latest_snapshot(str(tmp_path)) == p0


def test_chain_digest_detects_tampered_manifest(tmp_path):
    pool, _ = IngressPool.replay(JOURNAL)
    s = _session()
    _serve(s, pool, 1)
    path = s.snapshot(str(tmp_path), pool=pool)
    mpath = os.path.join(path, "manifest.json")
    manifest = json.load(open(mpath))
    manifest["replay_log"] = list(reversed(manifest["replay_log"]))
    json.dump(manifest, open(mpath, "w"))
    with pytest.raises(SnapshotError, match="chain digest"):
        load_snapshot(path)


def test_restore_refuses_empty_directory(tmp_path):
    with pytest.raises(SnapshotError, match="no complete snapshot"):
        restore_session(str(tmp_path), device="cpu")


# ------------------------------------------------- C3 recovery invariant
@pytest.mark.parametrize("snapshot_after", [0, 3, 99])
def test_restore_is_bitwise_identical(tmp_path, snapshot_after):
    """Mid-stream, at batch 0 (the whole stream replays) and after the
    final batch (nothing is left to drain)."""
    base = _uninterrupted()
    restored = _interrupted(tmp_path, snapshot_after=snapshot_after)
    assert restored.restored_from == 0
    assert (restored.recovery_batches == 0) == (snapshot_after == 99)
    assert restored.recovery_batches == len(restored.traces)
    _assert_bitwise_equal(restored, base)


def test_restore_under_a_different_budget_schedule(tmp_path):
    base = _uninterrupted(budgets=(5, 9, 3))
    restored = _interrupted(tmp_path, snapshot_after=2, budgets=(5, 9, 3))
    _assert_bitwise_equal(restored, base)


def test_restore_into_different_shards(tmp_path):
    base = _uninterrupted()
    restored = _interrupted(tmp_path / "a", snapshot_after=3,
                            restore_kw={"shards": 4}, shards=8)
    assert restored.store.layout.shards == 4
    _assert_bitwise_equal(restored, base)
    dense = _interrupted(tmp_path / "b", snapshot_after=2,
                         restore_kw={"shards": 1}, shards=8)
    assert dense.store.layout.shards == 1
    _assert_bitwise_equal(dense, base)


def test_restore_into_different_bucket_ladder_and_depth(tmp_path):
    base = _uninterrupted(bucket_ladder="pow2")
    restored = _interrupted(tmp_path, snapshot_after=3,
                            restore_kw={"bucket_ladder": "dense",
                                        "pipeline_depth": 2},
                            bucket_ladder="pow2")
    assert restored.bucket_ladder == "dense"
    assert restored.pipeline_depth == 2
    _assert_bitwise_equal(restored, base)


def test_double_restore_is_idempotent(tmp_path):
    base = _uninterrupted()
    pool, _ = IngressPool.replay(JOURNAL)
    s = _session()
    _serve(s, pool, 3)
    s.snapshot(str(tmp_path), pool=pool)
    outcomes = []
    for _ in range(2):
        s2, p2 = PotSession.restore(str(tmp_path), arrival_journal=JOURNAL,
                                    device="cpu")
        _drain_through(s2, p2)
        outcomes.append((s2.fingerprint(), tuple(s2.replay_log()),
                         [trace_digest(t) for t in s2.traces]))
        _assert_bitwise_equal(s2, base)
    assert outcomes[0] == outcomes[1]
    s3, p3 = PotSession.restore(str(tmp_path), arrival_journal=JOURNAL,
                                device="cpu")
    s3.snapshot(str(tmp_path), pool=p3)
    s4, p4 = PotSession.restore(str(tmp_path), arrival_journal=JOURNAL,
                                device="cpu")
    assert s4.restored_from == 1
    _drain_through(s4, p4)
    _assert_bitwise_equal(s4, base)


def test_pipelined_window_is_flushed_into_snapshot(tmp_path):
    base = _uninterrupted()
    pool, _ = IngressPool.replay(JOURNAL)
    s = _session(pipeline_depth=2, shards=8)
    _serve(s, pool, 3)
    assert len(s._window) > 0          # speculation pending
    path = s.snapshot(str(tmp_path), pool=pool)
    assert len(s._window) == 0         # flushed, not persisted
    manifest = json.load(open(os.path.join(path, "manifest.json")))
    assert manifest["n_txns"] == s.n_txns
    s2, p2 = PotSession.restore(str(tmp_path), arrival_journal=JOURNAL,
                                device="cpu")
    _drain_through(s2, p2)
    _assert_bitwise_equal(s2, base)


# ------------------------------------------------- C4 sequencer cursors
def test_run_stream_snapshot_restores_sequencer_cursor(tmp_path):
    wls = [W.counters(n_txns=k, n_objects=N_OBJECTS, n_reads=2,
                      n_writes=2, n_lanes=3, skew=0.6, seed=10 + k,
                      device="cpu") for k in (5, 9, 7, 11)]
    batches = [w.batch for w in wls]
    lanes = [w.lanes.tolist() for w in wls]
    base = PotSession(N_OBJECTS, engine="pcc", n_lanes=3, device="cpu")
    base.run_stream(batches, lanes)
    s = PotSession(N_OBJECTS, engine="pcc", n_lanes=3, device="cpu")
    s.run_stream(batches[:2], lanes[:2])
    assert any(s.sequencer._pending.values())   # cursor mid-refill
    s.snapshot(str(tmp_path))
    s2, pool2 = PotSession.restore(str(tmp_path), device="cpu")
    assert pool2 is None
    s2.run_stream(batches[2:], lanes[2:])
    _assert_bitwise_equal(s2, base)


@settings(max_examples=5, deadline=None)
@given(point=st.integers(min_value=0, max_value=6),
       schedule=st.sampled_from([(7, 11), (5, 9, 3)]),
       shards=st.sampled_from([1, 3, 8]))
def test_property_restored_equals_uninterrupted(tmp_path_factory, point,
                                                schedule, shards):
    tmp_path = tmp_path_factory.mktemp("snap")
    base = _uninterrupted(budgets=schedule)
    restored = _interrupted(tmp_path, snapshot_after=point,
                            budgets=schedule, shards=shards)
    _assert_bitwise_equal(restored, base)


# ----------------------------------------------- C5 across the packages
REF_JOURNAL = _journal(RefPool, ref_programs, ref_W)


def _ref_drain_through(session, pool, budgets=BUDGETS):
    while True:
        fb = pool.drain(budgets[session.batches_formed % len(budgets)])
        if fb is None:
            break
        session._serve_formed(fb)
    session._spec_flush()
    return session


def test_journals_and_trace_digests_agree_across_packages():
    """One arrival journal in both packages; the uninterrupted streams
    agree in fingerprint, replay log and every trace digest."""
    assert json.loads(json.dumps(REF_JOURNAL)) == \
        json.loads(json.dumps(JOURNAL))
    port = _uninterrupted(shards=8)
    ref = _ref_drain_through(RefSession(N_OBJECTS, engine="pcc",
                                        n_lanes=N_LANES, shards=8),
                             RefPool.replay(REF_JOURNAL)[0])
    _assert_bitwise_equal(port, ref, digest=ref_trace_digest)


def test_reference_snapshot_restores_into_the_port(tmp_path):
    """The reference snapshots at S = 8 mid-stream; the port restores it
    onto its dense store (S' = 1) and finishes the stream, equal to the
    reference's uninterrupted run."""
    ref_base = _ref_drain_through(
        RefSession(N_OBJECTS, engine="pcc", n_lanes=N_LANES, shards=8),
        RefPool.replay(REF_JOURNAL)[0])
    rpool = RefPool.replay(REF_JOURNAL)[0]
    rs = RefSession(N_OBJECTS, engine="pcc", n_lanes=N_LANES, shards=8)
    for _ in range(3):
        rs._serve_formed(rpool.drain(BUDGETS[rs.batches_formed % 2]))
    rs.snapshot(str(tmp_path), pool=rpool)
    s, pool = PotSession.restore(str(tmp_path), arrival_journal=JOURNAL,
                                 shards=1, device="cpu")
    assert s.store.layout.shards == 1 and s.restored_from == 0
    assert s.fingerprint() == rs.fingerprint()
    _drain_through(s, pool)
    _assert_bitwise_equal(s, ref_base, digest=ref_trace_digest)


def test_port_snapshot_restores_into_the_reference(tmp_path):
    """The port snapshots at S = 8 mid-stream; the reference restores it
    onto its dense store and finishes the stream, equal to the port's
    uninterrupted run."""
    base = _uninterrupted()
    pool, _ = IngressPool.replay(JOURNAL)
    s = _session(shards=8)
    _serve(s, pool, 3)
    s.snapshot(str(tmp_path), pool=pool)
    rs, rpool = RefSession.restore(str(tmp_path), arrival_journal=REF_JOURNAL,
                                   shards=1)
    assert rs.restored_from == 0 and rs.fingerprint() == s.fingerprint()
    _ref_drain_through(rs, rpool)
    assert rs.fingerprint() == base.fingerprint()
    assert rs.replay_log() == base.replay_log()
    bd = [trace_digest(t) for t in base.traces]
    rd = [ref_trace_digest(t) for t in rs.traces]
    assert rd == bd[len(bd) - len(rd):]
