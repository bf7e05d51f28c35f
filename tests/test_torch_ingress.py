"""Deterministic ingress in the port against the JAX reference: the
port's own copy of the admission pool and batch former
(``repro_torch.core.ingress``), ``PotSession.serve`` and the metrics
CSV (``repro_torch.core.metrics``).

One arrival journal through both packages' ``IngressPool`` must form the
same batches (programs, sequence numbers, lanes, admission ids, stamps,
ladder); serving it must give the reference's fingerprint,
``replay_log()`` and every trace field at any ``pipeline_depth`` (and,
for the engines whose outcome follows the sequence order alone, under
any budget schedule); and the metrics rows of the same traces must
equal the reference's, character for character.
"""

import inspect

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from _torch_parity import assert_traces_equal

from repro.core import RMW, WRITE
from repro.core import IngressPool as RefPool
from repro.core import JournalError as RefJournalError
from repro.core import PotSession as RefSession
from repro.core import metrics as ref_metrics
from repro.core.ingress import programs_from_batch as ref_programs
from repro.core.tstore import make_store as ref_make_store
from repro.core.txn import run_all as ref_run_all
from repro_torch import convert
from repro_torch.core import ingress, metrics
from repro_torch.core import workloads as W
from repro_torch.core.engine import TRACE_FIELDS
from repro_torch.core.ingress import (IngressPool, JournalError,
                                      programs_from_batch)
from repro_torch.core.session import PotSession
from repro_torch.core.tstore import make_store
from repro_torch.core.txn import run_all

ENGINES = ("pcc", "occ", "pogl", "destm")
N_OBJ = 48
N_LANES = 4


def _interleaved(pool_cls):
    """Lane events, fees, watermark evictions and drains interleaved with
    admissions; returns the pool and the batches it formed."""
    pool = pool_cls(capacity=12, evict_to=9, age_unit=4)
    pool.spawn_lane(0)
    pool.spawn_lane(1)
    pool.spawn_lane(5, parent=1)
    rng = np.random.default_rng(4)
    formed = []
    for i in range(60):
        lane = int(rng.integers(0, 7))
        if i == 30:
            pool.stop_lane(5)
        pool.admit(((RMW, int(rng.integers(0, 8)), False, i),
                    (WRITE, int(rng.integers(0, 8)), bool(i % 3 == 0),
                     1000 + i))[:1 + i % 2],
                   lane=lane, fee=int(rng.integers(0, 5)))
        if i % 15 == 14:
            formed.append(pool.drain(int(rng.integers(1, 12))))
    formed.extend(pool.drain_all(7))
    return pool, [fb for fb in formed if fb is not None]


def _assert_formed_equal(port, ref):
    assert len(port) == len(ref)
    for a, b in zip(port, ref):
        assert programs_from_batch(a.batch) == ref_programs(b.batch)
        got, exp = convert.formed_batch_to_numpy(a), \
            convert.formed_batch_to_numpy(convert.formed_batch_from_numpy(b))
        for f in ("lanes", "seq", "txn_ids", "stamps"):
            np.testing.assert_array_equal(got[f], exp[f], err_msg=f)
        for f, v in got["batch"].items():
            np.testing.assert_array_equal(v, exp["batch"][f], err_msg=f)
        assert (a.ladder, a.budget) == (b.ladder, b.budget)
        assert a.batch.opcodes.device.type == "cpu"


def test_formed_batches_match_reference():
    pool, formed = _interleaved(IngressPool)
    ref_pool, ref_formed = _interleaved(RefPool)
    assert pool.journal() == ref_pool.journal()
    assert pool.stats.evicted > 0 and pool.stats.rejected > 0
    _assert_formed_equal(formed, ref_formed)
    assert pool.observables() == ref_pool.observables()
    # the journal crosses: the reference's replayed through the port
    replayed_pool, replayed = IngressPool.replay(ref_pool.journal())
    _assert_formed_equal(replayed, ref_formed)
    assert replayed_pool.journal() == ref_pool.journal()


def test_journal_replay_reproduces_formed_batches():
    pool, formed = _interleaved(IngressPool)
    replayed_pool, replayed = IngressPool.replay(pool.journal())
    _assert_formed_equal(replayed, [convert.formed_batch_from_numpy(
        convert.formed_batch_to_numpy(fb)) for fb in formed])
    assert replayed_pool.depth == pool.depth == 0


def _bad_journals():
    pool, _ = _interleaved(IngressPool)
    j = pool.journal()
    admit = next(i for i, ev in enumerate(j) if ev[0] == "admit")
    return {
        "empty": [],
        "no config head": j[1:],
        "config mid-journal": j[:admit] + [j[0]] + j[admit:],
        "truncated admit": j[:admit] + [j[admit][:3]] + j[admit + 1:],
        "unknown event": j[:admit] + [("teleport", 1)] + j[admit:],
        "stamp backwards": j[:admit] + [j[admit], ("admit", 0) + j[admit][2:]]
        + j[admit + 1:],
    }


@pytest.mark.parametrize("case", list(_bad_journals()))
def test_replay_rejects_malformed_journals_as_the_reference(case):
    journal = _bad_journals()[case]
    with pytest.raises(RefJournalError) as ref_err:
        RefPool.replay(journal)
    with pytest.raises(JournalError) as err:
        IngressPool.replay(journal)
    assert str(err.value) == str(ref_err.value)
    assert issubclass(JournalError, ValueError)


def _arrivals(seed=9, k=30):
    """An arrival journal of a contended counters stream (fees drawn from
    the seed), with the programs both packages admit."""
    wl = W.counters(n_txns=k, n_objects=N_OBJ, n_reads=2, n_writes=2,
                    n_lanes=N_LANES, skew=0.8, seed=seed, device="cpu")
    rng = np.random.default_rng(seed)
    pool = IngressPool(capacity=64)
    for p, lane in zip(programs_from_batch(wl.batch), wl.lanes.tolist()):
        pool.admit(p, lane=lane, fee=int(rng.integers(0, 5)))
    return pool.arrival_journal()


def _serve_in_steps(session, pool, budgets):
    traces = []
    for b in budgets:
        traces += session.serve(pool, b, max_batches=1)
    traces += session.serve(pool, 5)
    return traces


@pytest.fixture(scope="module")
def ref_served():
    runs = {}

    def get(engine, depth):
        if (engine, depth) not in runs:
            pool, _ = RefPool.replay(_arrivals())
            s = RefSession(N_OBJ, engine=engine, n_lanes=N_LANES,
                           pipeline_depth=depth)
            traces = s.serve(pool, budget=8)
            runs[engine, depth] = s, traces
        return runs[engine, depth]

    return get


# the engines whose outcome depends on the sequence order alone, so that
# any budget schedule draining the same prefix gives the same store (OCC's
# arrival waves and DeSTM's rounds depend on how the order is cut)
SEQUENCE_ORDERED = ("pcc", "pogl")


@pytest.mark.parametrize("engine", ENGINES)
def test_serve_matches_reference_under_budget_schedules(engine, ref_served):
    ref, ref_traces = ref_served(engine, 0)
    pool, _ = IngressPool.replay(_arrivals())
    s = PotSession(N_OBJ, engine=engine, n_lanes=N_LANES, device="cpu")
    traces = s.serve(pool, budget=8)
    assert pool.depth == 0 and s.batches_formed == len(traces) == 4
    assert s.fingerprint() == ref.fingerprint()
    assert s.replay_log() == ref.replay_log()
    assert_traces_equal(traces, ref_traces, engine)
    assert s.bucket_counts() == ref.bucket_counts()
    assert s.compile_count() == ref.compile_count()
    if engine not in SEQUENCE_ORDERED:
        return
    other, _ = IngressPool.replay(_arrivals())
    s2 = PotSession(N_OBJ, engine=engine, n_lanes=N_LANES, device="cpu")
    _serve_in_steps(s2, other, [3, 11, 1, 7])
    assert s2.fingerprint() == s.fingerprint()
    assert s2.replay_log() == s.replay_log()
    assert s2.n_txns == 30


@pytest.mark.parametrize("engine", ENGINES)
def test_pipelined_serve_matches_serial_and_reference(engine, ref_served):
    ref, ref_traces = ref_served(engine, 2)
    serial = PotSession(N_OBJ, engine=engine, n_lanes=N_LANES, device="cpu")
    t0 = serial.serve(IngressPool.replay(_arrivals())[0], budget=8)
    s = PotSession(N_OBJ, engine=engine, n_lanes=N_LANES, pipeline_depth=2,
                   device="cpu")
    t1 = s.serve(IngressPool.replay(_arrivals())[0], budget=8)
    assert not s._window and s.batches_formed == 4
    assert sum(int(t.spec_executed) for t in t1) == 30
    for a, b in zip(t0, t1):
        for f in TRACE_FIELDS:
            if not f.startswith("spec_"):
                assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert s.fingerprint() == serial.fingerprint() == ref.fingerprint()
    assert s.replay_log() == serial.replay_log() == ref.replay_log()
    assert_traces_equal(t1, ref_traces, f"{engine} D=2")
    # another depth (and, where the outcome allows, another budget)
    s3 = PotSession(N_OBJ, engine=engine, n_lanes=N_LANES, pipeline_depth=1,
                    device="cpu")
    s3.serve(IngressPool.replay(_arrivals())[0],
             budget=5 if engine in SEQUENCE_ORDERED else 8)
    assert s3.fingerprint() == s.fingerprint()
    assert s3.replay_log() == s.replay_log()


def test_serve_max_batches_empty_pool_and_ladder():
    s = PotSession(8, device="cpu")
    pool = IngressPool(capacity=64)
    assert s.serve(pool, budget=4) == [] and s.batches_formed == 0
    for i in range(33):
        pool.admit(((WRITE, i % 8, False, i),), lane=0)
    traces = s.serve(pool, budget=4, max_batches=2)
    assert len(traces) == 2 and pool.depth == 25 and s.batches_formed == 2
    # the pool's ladder recommendation picks the bucket: 33 rows pad to
    # 40 on the dense ladder; pinning pow2 pads to 64
    pool2 = IngressPool(capacity=64)
    for i in range(33):
        pool2.admit(((WRITE, i % 8, False, i),), lane=0)
    twin, _ = IngressPool.replay(pool2.arrival_journal())
    dense = PotSession(8, device="cpu")
    dense.serve(pool2, budget=33)
    pinned = PotSession(8, device="cpu")
    pinned.serve(twin, budget=33, ladder="pow2")
    assert (40, 1) in dense.bucket_counts()
    assert (64, 1) in pinned.bucket_counts()
    assert dense.fingerprint() == pinned.fingerprint()


@pytest.mark.parametrize("engine", ENGINES)
def test_metrics_rows_match_reference(engine, ref_served):
    ref, ref_traces = ref_served(engine, 0)
    pool, _ = IngressPool.replay(_arrivals())
    ref_pool, _ = RefPool.replay(_arrivals())
    s = PotSession(N_OBJ, engine=engine, n_lanes=N_LANES, device="cpu")
    fb, ref_fb = pool.drain(30), ref_pool.drain(30)
    trace = s._serve_formed(fb)[0]
    ref_s = RefSession(N_OBJ, engine=engine, n_lanes=N_LANES)
    ref_trace = ref_s._serve_formed(ref_fb)[0]
    res = run_all(fb.batch, make_store(N_OBJ, device="cpu").values)
    ref_res = ref_run_all(ref_fb.batch, ref_make_store(N_OBJ).values)
    row = metrics.report_from_trace(engine, trace, fb.batch, res.rn, res.wn,
                                    n_lanes=N_LANES, session=s,
                                    pool=pool).row()
    ref_row = ref_metrics.report_from_trace(
        engine, ref_trace, ref_fb.batch, np.asarray(ref_res.rn),
        np.asarray(ref_res.wn), n_lanes=N_LANES, session=ref_s,
        pool=ref_pool).row()
    assert row == ref_row
    assert metrics.HEADER == ref_metrics.HEADER
    assert len(row.split(",")) == len(metrics.HEADER.split(","))
    # a pipelined session's trace carries its spec_* columns
    piped = PotSession(N_OBJ, engine=engine, n_lanes=N_LANES,
                       pipeline_depth=1, device="cpu")
    t = piped.serve(IngressPool.replay(_arrivals())[0], budget=30)[0]
    rep = metrics.report_from_trace(engine, t, fb.batch, res.rn, res.wn,
                                    n_lanes=N_LANES, session=piped)
    assert (rep.spec_executed, rep.pipeline_depth, rep.spec_engine) == \
        (30, 1, 1)


def test_no_wall_clock_or_rng_in_ingress_module():
    """The no-wall-clock rule, mechanically: the port's ingress module
    imports no time or random source; all ordering is logical."""
    src = inspect.getsource(ingress)
    for needle in ("import time", "import random", "datetime",
                   "perf_counter", "default_rng", "import torch"):
        assert needle not in src, needle
