"""The port's other three engines (OCC, PoGL, DeSTM) against the JAX
reference, bitwise: store values, versions, ``gv``, the fingerprint and
every ``ExecTrace`` field, through ``get_engine(name).execute``, the
``*_execute`` shims with every knob, and ``PotSession`` streams with
ragged K under both bucket ladders.

Each comparison runs twice: on the port's CPU path (the scatter-min
formulation) and with ``ops._on_cuda`` patched to True, so that the
matrix formulation the card takes (OCC's carried table through the
delta kernel and the pair kernel's strips) runs through the kernels'
plain versions.  DeSTM's retry waves reach the pair kernel in either
formulation (``ops.cross_conflicts``).  Beside the parity: OCC's outcome
depends on its arrival order and replays through PCC, DeSTM's wave walk
equals its serial walk, and property tests hold PoGL to the numpy serial
oracle and DeSTM to PoGL.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from _hypothesis_compat import given, settings, st
from _torch_parity import assert_traces_equal, ref_batch

from repro.core import workloads as ref_W
from repro.core.destm import destm_execute as ref_destm_execute
from repro.core.engine import get_engine as ref_get_engine
from repro.core.occ import occ_execute as ref_occ_execute
from repro.core.pogl import pogl_execute as ref_pogl_execute
from repro.core.sequencer import RoundRobinSequencer
from repro.core.session import PotSession as RefSession
from repro.core.tstore import fingerprint as ref_fingerprint
from repro.core.tstore import make_store as ref_make_store
from repro_torch import convert
from repro_torch.core import oracle, protocol
from repro_torch.core import workloads as W
from repro_torch.core.destm import destm_execute
from repro_torch.core.engine import TRACE_FIELDS, get_engine
from repro_torch.core.occ import occ_execute
from repro_torch.core.pcc import pcc_execute
from repro_torch.core.pogl import pogl_execute
from repro_torch.core.sequencer import ReplaySequencer
from repro_torch.core.session import PotSession
from repro_torch.core.tstore import fingerprint, make_store
from repro_torch.core.txn import pad_batch
from repro_torch.kernels import conflict, ops

ENGINES = ("occ", "pogl", "destm")
N_LANES = 4
RAGGED_K = (5, 17, 12)   # pow2 buckets 8, 32, 16; dense 8, 24, 16


def _workload(pkg, name, seed=0, **kw):
    if name == "counters":
        return pkg.counters(n_txns=24, n_objects=32, n_reads=2, n_writes=2,
                            n_lanes=N_LANES, skew=0.8, seed=seed, **kw)
    if name == "vacation":
        return pkg.vacation_like(n_txns=24, n_objects=128, n_lanes=N_LANES,
                                 seed=seed, **kw)
    return pkg.labyrinth_like(n_txns=16, n_objects=256, path_len=8,
                              n_lanes=N_LANES, seed=seed, **kw)


def _seq(wl):
    return np.asarray(RoundRobinSequencer(n_root_lanes=wl.n_lanes).order_for(
        wl.lanes.tolist()), np.int32)


def _init(n_objects):
    return np.random.default_rng(n_objects).integers(
        -50, 50, (n_objects, 1)).astype(np.int32)


def _arrival(k, seed=9):
    return np.random.default_rng(seed).permutation(k).astype(np.int32)


@pytest.fixture(params=["scatter", "matrix"])
def formulation(request, monkeypatch):
    """Counts the conflict-kernel wrapper calls; ``matrix`` forces the
    card's formulation on CPU tensors."""
    calls = {"pair": 0, "delta": 0}
    if request.param == "matrix":
        monkeypatch.setattr(ops, "_on_cuda", lambda t: True)
    for key, name in (("pair", "conflict_matrix_bits_pair"),
                      ("delta", "conflict_matrix_bits_delta")):
        def counted(*args, _fn=getattr(conflict, name), _key=key):
            calls[_key] += 1
            return _fn(*args)
        monkeypatch.setattr(conflict, name, counted)
    return request.param, calls


def _assert_store_equal(port, ref, msg=""):
    for f in ("values", "versions", "gv"):
        np.testing.assert_array_equal(getattr(port, f).numpy(),
                                      np.asarray(getattr(ref, f)),
                                      err_msg=f"{msg} {f}")
    assert fingerprint(port) == int(ref_fingerprint(ref)), msg


def _assert_calls(engine, formulation, trace, wave=True):
    """Which conflict kernels each engine reaches, per formulation."""
    kind, calls = formulation
    if engine == "occ" and kind == "matrix":
        assert calls["delta"] > 0, calls
    elif engine == "destm":
        # no table is carried, but every retry wave asks the pair kernel
        # (the serial token walk asks it nothing)
        assert calls["delta"] == 0, calls
        waves = wave and int(trace.retry_waves) > 0
        assert (calls["pair"] > 0) == waves, calls
    else:
        assert calls == {"pair": 0, "delta": 0}, calls


@pytest.fixture(scope="module")
def reference():
    """Reference results, computed once per key."""
    runs = {}

    def get(key, fn):
        if key not in runs:
            runs[key] = fn()
        return runs[key]

    return get


# ------------------------------------------------------------- registry
@pytest.mark.parametrize("wname", ["counters", "vacation", "labyrinth"])
@pytest.mark.parametrize("engine", ENGINES)
def test_engine_matches_reference(engine, wname, formulation, reference):
    def run_ref():
        wl = _workload(ref_W, wname, seed=1)
        return ref_get_engine(engine).execute(
            ref_make_store(wl.n_objects, init=_init(wl.n_objects)),
            wl.batch, _seq(wl), lanes=np.asarray(wl.lanes),
            n_lanes=N_LANES)

    ref_store, ref_trace = reference(("registry", engine, wname), run_ref)
    wl = _workload(W, wname, seed=1, device="cpu")
    store = make_store(wl.n_objects, init=_init(wl.n_objects), device="cpu")
    out, trace = get_engine(engine).execute(
        store, wl.batch, _seq(wl), lanes=np.asarray(wl.lanes),
        n_lanes=N_LANES)
    assert_traces_equal([trace], [ref_trace], f"{engine}/{wname}")
    _assert_store_equal(out, ref_store, f"{engine}/{wname}")
    # the input store is left as it was
    np.testing.assert_array_equal(store.values.numpy(),
                                  _init(wl.n_objects))
    assert int(store.gv) == 0
    _assert_calls(engine, formulation, trace)


# ---------------------------------------------------------------- knobs
_OCC_CASES = [
    dict(),
    dict(incremental=False),
    dict(compact=False),
    dict(wave_block=1),
    dict(max_waves=2),
]


def _ids(kw):
    return "-".join(f"{k}={v}" for k, v in kw.items()) or "default"


@pytest.mark.parametrize("kw", _OCC_CASES, ids=_ids)
def test_occ_execute_matches_reference(kw, formulation, reference):
    arrival = _arrival(24)

    def run_ref():
        wl = _workload(ref_W, "counters", seed=2)
        return ref_occ_execute(
            ref_make_store(wl.n_objects, init=_init(wl.n_objects)),
            wl.batch, jnp.asarray(arrival), **kw)

    ref_store, ref_trace = reference(("occ", _ids(kw)), run_ref)
    wl = _workload(W, "counters", seed=2, device="cpu")
    out, trace = occ_execute(
        make_store(wl.n_objects, init=_init(wl.n_objects), device="cpu"),
        wl.batch, torch.from_numpy(arrival), **kw)
    assert_traces_equal([trace], [ref_trace], _ids(kw))
    _assert_store_equal(out, ref_store, _ids(kw))
    if "max_waves" in kw:
        assert (trace.commit_pos < 0).any()   # the cap left rows pending
    _assert_calls("occ", formulation, trace)


def test_occ_wave_block_changes_only_the_trip_count():
    wl = _workload(W, "counters", seed=2, device="cpu")
    store = make_store(wl.n_objects, device="cpu")
    arrival = torch.from_numpy(_arrival(24))
    s1, t1 = occ_execute(store, wl.batch, arrival, wave_block=1)
    s8, t8 = occ_execute(store, wl.batch, arrival, wave_block=8)
    assert fingerprint(s1) == fingerprint(s8)
    for f in TRACE_FIELDS:
        if f != "wave_trips":
            assert torch.equal(getattr(t1, f), getattr(t8, f)), f
    assert int(t8.wave_trips) < int(t1.wave_trips)


_DESTM_CASES = [
    dict(),
    dict(wave=False),
    dict(incremental=False),
    dict(compact=False),
    dict(max_rounds=2),
    dict(max_rounds=2, wave=False),
]


@pytest.mark.parametrize("kw", _DESTM_CASES, ids=_ids)
def test_destm_execute_matches_reference(kw, formulation, reference):
    def run_ref():
        wl = _workload(ref_W, "counters", seed=3)
        return ref_destm_execute(
            ref_make_store(wl.n_objects, init=_init(wl.n_objects)),
            wl.batch, jnp.asarray(_seq(wl)), jnp.asarray(wl.lanes, jnp.int32),
            N_LANES, **kw)

    ref_store, ref_trace = reference(("destm", _ids(kw)), run_ref)
    wl = _workload(W, "counters", seed=3, device="cpu")
    out, trace = destm_execute(
        make_store(wl.n_objects, init=_init(wl.n_objects), device="cpu"),
        wl.batch, torch.from_numpy(_seq(wl)), torch.from_numpy(wl.lanes),
        N_LANES, **kw)
    assert_traces_equal([trace], [ref_trace], _ids(kw))
    _assert_store_equal(out, ref_store, _ids(kw))
    if "max_rounds" in kw:
        uncommitted = trace.commit_round < 0
        assert uncommitted.any()
        assert (trace.commit_pos[uncommitted] == -1).all()
    _assert_calls("destm", formulation, trace, kw.get("wave", True))


def test_pogl_execute_matches_reference_with_vacant_rows():
    """The shim walks every row, vacant ones as no-ops, and advances gv by
    the padded K, as the reference's does."""
    wl = _workload(W, "vacation", seed=4, device="cpu")
    seq = np.concatenate([_seq(wl), 25 + np.arange(8, dtype=np.int32)])
    batch = pad_batch(wl.batch, 32, wl.batch.max_ins)
    out = pogl_execute(make_store(128, init=_init(128), device="cpu"), batch,
                       torch.from_numpy(seq))
    exp = ref_pogl_execute(ref_make_store(128, init=_init(128)),
                           ref_batch(convert.batch_to_numpy(batch)),
                           jnp.asarray(seq))
    _assert_store_equal(out, exp)
    assert int(out.gv) == 32


def test_destm_carries_no_conflict_table(monkeypatch):
    """init_round_state(track_conflict=False) allocates no table and no
    packed bitsets, even in the card's formulation."""
    monkeypatch.setattr(ops, "_on_cuda", lambda t: True)
    wl = _workload(W, "counters", device="cpu")
    store = make_store(32, device="cpu")
    rs = protocol.init_round_state(wl.batch, store.values, store.versions,
                                   track_conflict=False)
    assert rs.conflict is None and rs.foot_bits is None \
        and rs.write_bits is None
    rs = protocol.init_round_state(wl.batch, store.values, store.versions)
    assert rs.conflict.shape == (24, 24) and rs.foot_bits.shape == (24, 1)


# ------------------------------------------------------------- sessions
def _stream(pkg, **kw):
    return [pkg.counters(n_txns=k, n_objects=48, n_reads=2, n_writes=2,
                         n_lanes=N_LANES, skew=0.8, seed=seed, **kw)
            for seed, k in enumerate(RAGGED_K)]


@pytest.mark.parametrize("ladder", ["pow2", "dense"])
@pytest.mark.parametrize("engine", ENGINES)
def test_session_matches_reference(engine, ladder, formulation, reference):
    def run_ref():
        wls = _stream(ref_W)
        s = RefSession(48, engine=engine, n_lanes=N_LANES,
                       bucket_ladder=ladder)
        traces = s.run_stream([w.batch for w in wls],
                              [w.lanes for w in wls])
        return dict(session=s, traces=traces, fingerprint=s.fingerprint(),
                    replay_log=s.replay_log(), gv=int(s.store.gv),
                    values=np.asarray(s.store.values),
                    versions=np.asarray(s.store.versions))

    ref = reference(("session", engine, ladder), run_ref)
    wls = _stream(W, device="cpu")
    s = PotSession(48, engine=engine, n_lanes=N_LANES, bucket_ladder=ladder,
                   device="cpu")
    traces = s.run_stream([w.batch for w in wls], [w.lanes for w in wls])
    assert s.fingerprint() == ref["fingerprint"]
    assert s.replay_log() == ref["replay_log"]
    assert_traces_equal(traces, ref["traces"], f"{engine}/{ladder}")
    np.testing.assert_array_equal(s.store.values.numpy(), ref["values"])
    np.testing.assert_array_equal(s.store.versions.numpy(), ref["versions"])
    assert s.gv == ref["gv"] == sum(RAGGED_K)   # vacant rows never commit
    assert s.bucket_counts() == ref["session"].bucket_counts()
    for a, b in zip(s.live_counts(), ref["session"].live_counts()):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(s.wave_counts(), ref["session"].wave_counts()):
        np.testing.assert_array_equal(a, b)
    if engine == "destm":
        assert sum(int(t.retry_waves) for t in traces) > 0


def test_deterministic_engines_on_a_stream():
    """PoGL and PCC commit a stream in its sequence order: one
    fingerprint, one replay log.  DeSTM's serialization is round-major
    (rounds in order, the token order within one), which differs from
    the sequence order once the global round-robin sequencer leaves the
    lanes unevenly loaded (batch 2 of this stream); its store is then
    PoGL's under DeSTM's own commit order."""
    wls = _stream(W, device="cpu")
    batches, lanes = [w.batch for w in wls], [w.lanes for w in wls]
    runs = {}
    for engine in ("pcc", "pogl", "destm"):
        s = PotSession(48, engine=engine, n_lanes=N_LANES, device="cpu")
        s.run_stream(batches, lanes)
        runs[engine] = s
    assert runs["pcc"].fingerprint() == runs["pogl"].fingerprint()
    assert runs["pcc"].replay_log() == runs["pogl"].replay_log()
    destm = runs["destm"]
    assert destm.replay_log() != runs["pogl"].replay_log()
    replay = PotSession(48, engine="pogl",
                        sequencer=destm.replay_sequencer(), device="cpu")
    replay.run_stream(batches)
    assert replay.fingerprint() == destm.fingerprint()
    assert replay.replay_log() == destm.replay_log()


# ------------------------------------------------------- OCC behaviour
def test_occ_is_nondeterministic_witness(reference):
    """The outcome depends on the arrival interleaving (the problem Pot
    removes), and each arrival's outcome is the reference's."""
    wl = W.counters(n_txns=16, n_objects=8, n_reads=2, n_writes=2,
                    n_lanes=4, skew=0.0, seed=12, device="cpu")
    rwl = ref_W.counters(n_txns=16, n_objects=8, n_reads=2, n_writes=2,
                         n_lanes=4, skew=0.0, seed=12)
    rng = np.random.default_rng(3)
    fps = set()
    for i in range(8):
        arrival = rng.permutation(16).astype(np.int32)
        out, _ = occ_execute(make_store(8, device="cpu"), wl.batch,
                             torch.from_numpy(arrival))
        exp, _ = ref_occ_execute(ref_make_store(8), rwl.batch,
                                 jnp.asarray(arrival))
        assert fingerprint(out) == int(ref_fingerprint(exp)), i
        fps.add(fingerprint(out))
    assert len(fps) > 1, "expected arrival-order-dependent outcomes"


def test_occ_record_replay_through_pcc():
    """Record OCC's commit order, replay it as PCC's sequence order: PCC
    reproduces OCC's store (paper §2.1)."""
    wl = W.vacation_like(n_txns=16, n_objects=64, n_lanes=4, seed=5,
                         device="cpu")
    store = make_store(64, device="cpu")
    arrival = torch.from_numpy(_arrival(16))
    occ_out, occ_trace = occ_execute(store, wl.batch, arrival)
    order = np.argsort(occ_trace.commit_pos.numpy())
    seq = ReplaySequencer(order.tolist()).order_for(wl.lanes.tolist())
    replay_out, _ = pcc_execute(store, wl.batch,
                                torch.as_tensor(seq, dtype=torch.int32))
    assert torch.equal(replay_out.values, occ_out.values)
    assert int(occ_trace.retries.sum()) > 0   # the arrival mattered


# --------------------------------------------------------- DeSTM modes
WAVE_FIELDS = {"retry_waves", "waves_per_round"}


def _destm_both(wl):
    store = make_store(wl.n_objects, device="cpu")
    seq = torch.from_numpy(_seq(wl))
    lanes = torch.from_numpy(wl.lanes)
    return (destm_execute(store, wl.batch, seq, lanes, wl.n_lanes, wave=True),
            destm_execute(store, wl.batch, seq, lanes, wl.n_lanes,
                          wave=False))


def _assert_wave_equals_serial(wl, ctx):
    (sw, tw), (ss, ts) = _destm_both(wl)
    assert fingerprint(sw) == fingerprint(ss), ctx
    assert torch.equal(sw.versions, ss.versions) and int(sw.gv) == int(ss.gv)
    for f in TRACE_FIELDS:
        if f not in WAVE_FIELDS:
            assert torch.equal(getattr(tw, f), getattr(ts, f)), (ctx, f)
    events, waves = int(ts.retry_waves), int(tw.retry_waves)
    assert events == int(ts.retries.sum()), ctx   # serial trips = events
    assert waves <= events, ctx
    assert (tw.wave_counts() <= ts.wave_counts()).all(), ctx
    return sw, tw, ts


@pytest.mark.parametrize("k", [1, 2, 64])
@pytest.mark.parametrize("contention", ["low", "high"])
@pytest.mark.parametrize("n_lanes", [1, 8])
def test_destm_wave_equals_serial_walk(k, contention, n_lanes):
    n_lanes = min(n_lanes, k)
    if contention == "low":
        wl = W.counters(n_txns=k, n_objects=max(64, 8 * k), n_reads=2,
                        n_writes=2, n_lanes=n_lanes, skew=0.0,
                        seed=3 * k + n_lanes, device="cpu")
    else:
        wl = W.counters(n_txns=k, n_objects=max(4, k // 4), n_reads=2,
                        n_writes=2, n_lanes=n_lanes, skew=1.0,
                        seed=3 * k + n_lanes, device="cpu")
    sw, _, _ = _assert_wave_equals_serial(wl, f"{k} {contention} {n_lanes}")
    oracle_store = pogl_execute(make_store(wl.n_objects, device="cpu"),
                                wl.batch, torch.from_numpy(_seq(wl)))
    assert fingerprint(sw) == fingerprint(oracle_store)


def test_destm_waves_beat_events_on_blind_writes():
    """Blind write-write conflicts: the wave retires every conflicting
    member of a round at once, so waves < events."""
    wl = W.counters(n_txns=64, n_objects=16, n_reads=2, n_writes=2,
                    n_lanes=8, skew=1.0, seed=5, device="cpu")
    _, tw, ts = _assert_wave_equals_serial(wl, "blind")
    assert int(tw.retry_waves) < int(ts.retry_waves)


# ------------------------------------------------------ property tests
@settings(max_examples=12, deadline=None)
@given(st.integers(1, 20), st.sampled_from([4, 16, 64]),
       st.integers(1, 8),
       st.one_of(st.just(0.0), st.floats(1e-6, 2.0)),
       st.integers(0, 2 ** 16))
def test_pogl_equals_oracle_and_destm_equals_pogl(k, n_objects, n_lanes,
                                                  skew, seed):
    """Skews are 0 or at least 1e-6: below that the workload generator's
    zipf(1 + skew) rounds to zipf(1.0), which numpy refuses."""
    n_lanes = min(n_lanes, k)
    wl = W.counters(n_txns=k, n_objects=n_objects, n_reads=2, n_writes=2,
                    n_lanes=n_lanes, skew=skew, seed=seed, device="cpu")
    seq = _seq(wl)
    store = make_store(n_objects, device="cpu")
    pogl, ptrace = get_engine("pogl").execute(store, wl.batch, seq)
    values, versions, gv = oracle.serial_execute(
        np.zeros((n_objects, 1), np.int32), np.zeros(n_objects, np.int32),
        0, [convert.batch_to_numpy(wl.batch)], [seq])
    np.testing.assert_array_equal(pogl.values.numpy(), values)
    np.testing.assert_array_equal(pogl.versions.numpy(), versions)
    assert int(pogl.gv) == gv == k
    destm, dtrace = get_engine("destm").execute(
        store, wl.batch, seq, lanes=wl.lanes, n_lanes=n_lanes)
    for f in ("values", "versions", "gv"):
        assert torch.equal(getattr(destm, f), getattr(pogl, f)), f
    # one committed history: DeSTM's order is round-major, PoGL's the
    # sequence order; with one round-robin order they coincide
    assert torch.equal(dtrace.commit_pos, ptrace.commit_pos)


@pytest.mark.parametrize("shim", [pcc_execute, occ_execute, destm_execute],
                         ids=["pcc", "occ", "destm"])
def test_seeded_shims_equal_unseeded(shim):
    """``seed=`` on each shim, with and without the compact cascade: a
    speculation made before another batch committed gives the unseeded
    call's store and every trace field but ``spec_*``."""
    first = _workload(W, "counters", seed=5, device="cpu")
    wl = _workload(W, "counters", device="cpu")
    store0 = make_store(32, init=_init(32), device="cpu")
    seed = protocol.spec_execute(store0, wl.batch)
    store1, _ = get_engine("pcc").execute(store0, first.batch, _seq(first))
    if shim is occ_execute:
        order = torch.from_numpy(_arrival(wl.batch.n_txns))
        args = (order,)
    else:
        args = (torch.from_numpy(_seq(wl)),)
        if shim is destm_execute:
            args += (torch.from_numpy(wl.lanes.astype(np.int32)), N_LANES)
    for kw in (dict(), dict(compact=False)):
        plain_store, plain = shim(store1, wl.batch, *args, **kw)
        out, trace = shim(store1, wl.batch, *args, seed=seed, **kw)
        for f in ("values", "versions", "gv"):
            assert torch.equal(getattr(out, f), getattr(plain_store, f)), f
        for f in TRACE_FIELDS:
            if not f.startswith("spec_"):
                assert torch.equal(getattr(trace, f), getattr(plain, f)), \
                    (kw, f)
        assert int(trace.spec_executed) == wl.batch.n_txns
        assert int(trace.spec_rounds) == 1 and int(trace.spec_invalidated)
