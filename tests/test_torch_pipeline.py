"""Cross-batch speculative pipelining in the port against the JAX
reference, bitwise: the dirty-set packing and the read-set validation
(``ops.spec_dirty_words`` / ``spec_read_invalid``), the re-base of a
speculative round 0 (``protocol.seed_round_state``), each engine's seeded
entry point (``raw_spec``) and ``PotSession(pipeline_depth=D)`` streams.

The invariant: a seeded call equals the unseeded call on the same store
in the store and every trace field but ``spec_*``, and a pipelined
stream equals the serial stream the same way; the ``spec_*`` fields
equal the reference's.  Each comparison runs in both formulations: the
port's CPU path (scatter-min, the dense version gather) and with
``ops._on_cuda`` patched to True, so that the card's route (packed read
sets through the validation kernel's plain version, seeds carrying the
conflict table) runs on CPU tensors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from _hypothesis_compat import given, settings, st
from _torch_parity import assert_results_equal, assert_traces_equal

from repro.core import protocol as ref_protocol
from repro.core import workloads as ref_W
from repro.core.engine import get_engine as ref_get_engine
from repro.core.sequencer import RoundRobinSequencer
from repro.core.session import PotSession as RefSession
from repro.core.tstore import make_store as ref_make_store
from repro.core.tstore import store_with as ref_store_with
from repro.kernels import ops as ref_ops
from repro_torch import convert
from repro_torch.core import protocol
from repro_torch.core import workloads as W
from repro_torch.core.engine import TRACE_FIELDS, EngineDef, get_engine
from repro_torch.core.session import PotSession
from repro_torch.core.tstore import make_store, store_with
from repro_torch.core.txn import run_all
from repro_torch.kernels import conflict, ops, validate

ENGINES = ("pcc", "occ", "pogl", "destm")
N_OBJ = 96
N_LANES = 8
STREAM_K = (13, 16, 7)   # pow2 buckets 16, 16, 8


def _wl(pkg, k, seed, skew=0.8, n_objects=N_OBJ, **kw):
    return pkg.counters(n_txns=k, n_objects=n_objects, n_reads=3,
                        n_writes=3, n_lanes=N_LANES, skew=skew, seed=seed,
                        **kw)


def _stream(pkg, seed=0, **kw):
    wls = [_wl(pkg, k, seed + 100 + i, **kw)
           for i, k in enumerate(STREAM_K)]
    return [w.batch for w in wls], [w.lanes for w in wls]


def _seq(lanes):
    return np.asarray(RoundRobinSequencer(n_root_lanes=N_LANES).order_for(
        list(lanes)), np.int32)


def _init(seed=0, n_objects=N_OBJ):
    return np.random.default_rng(seed).integers(
        -50, 50, (n_objects, 1)).astype(np.int32)


@pytest.fixture(params=["scatter", "matrix"])
def formulation(request, monkeypatch):
    """Counts the validation and conflict wrappers' calls; ``matrix``
    forces the card's formulation on CPU tensors."""
    calls = {"validate": 0, "delta": 0}
    if request.param == "matrix":
        monkeypatch.setattr(ops, "_on_cuda", lambda t: True)
        for key, mod, name in (
                ("validate", validate, "validate_bitsets"),
                ("delta", conflict, "conflict_matrix_bits_delta")):
            def counted(*args, _fn=getattr(mod, name), _key=key):
                calls[_key] += 1
                return _fn(*args)
            monkeypatch.setattr(mod, name, counted)
    return request.param, calls


def _assert_matrix_route(formulation, *keys):
    kind, calls = formulation
    for key in keys:
        assert (calls[key] > 0) == (kind == "matrix"), (kind, calls)


def _assert_equal_but_spec(serial, pipelined, msg=""):
    """Every trace field but ``spec_*`` bitwise equal; the serial run's
    ``spec_*`` zero."""
    assert len(serial) == len(pipelined), msg
    for i, (a, b) in enumerate(zip(serial, pipelined)):
        a, b = convert.trace_to_numpy(a), convert.trace_to_numpy(b)
        for f in TRACE_FIELDS:
            if f.startswith("spec_"):
                assert a[f] == 0, f"{msg} serial {f}"
            else:
                np.testing.assert_array_equal(
                    a[f], b[f], err_msg=f"{msg} batch {i} field {f}")


def _dirty_case(seed, n_objects=N_OBJ):
    """Versions around a snapshot at 10 (about one in twelve above it:
    dirty), with every address whose bit is 31 (a % 32 == 31) dirty."""
    rng = np.random.default_rng(seed)
    versions = rng.integers(0, 12, (n_objects,)).astype(np.int32)
    versions[31::32] = 99
    return versions, np.int32(10)


# ------------------------------------------------ the validation strip
@pytest.mark.parametrize("n_objects", [70, 96, 1000])
def test_spec_dirty_words_match_reference(n_objects):
    versions, snap = _dirty_case(n_objects, n_objects)
    got = ops.spec_dirty_words(torch.from_numpy(versions),
                               torch.tensor(snap), n_objects)
    exp = np.asarray(ref_ops.spec_dirty_words(
        jnp.asarray(versions), jnp.asarray(snap), n_objects))
    assert got.dtype == torch.int32 and got.shape == (-(-n_objects // 32),)
    np.testing.assert_array_equal(got.numpy(), exp)
    assert (got.numpy() < 0).any(), "no word carries bit 31"
    # against the definition, word by word
    dirty = np.zeros(got.shape[0] * 32, bool)
    dirty[:n_objects] = versions > snap
    words = (dirty.reshape(-1, 32).astype(np.uint64)
             << np.arange(32, dtype=np.uint64)).sum(1)
    np.testing.assert_array_equal(got.numpy(),
                                  words.astype(np.uint32).view(np.int32))


@pytest.mark.parametrize("seed", [0, 1])
def test_spec_read_invalid_matches_reference_and_oracle(seed, formulation):
    wl = _wl(W, 24, seed, skew=1.0, device="cpu")
    res = run_all(wl.batch, torch.from_numpy(_init(seed)))
    versions, snap = _dirty_case(seed)
    got = protocol.speculation_invalid(res, torch.from_numpy(versions),
                                       torch.tensor(snap))
    exp = np.asarray(ref_ops.spec_read_invalid(
        jnp.asarray(res.raddrs.numpy()), jnp.asarray(res.rn.numpy()),
        jnp.asarray(versions), jnp.asarray(snap), N_OBJ))
    raddrs, rn = res.raddrs.numpy(), res.rn.numpy()
    oracle = np.array([(versions[raddrs[t, :rn[t]]] > snap).any()
                       for t in range(raddrs.shape[0])])
    np.testing.assert_array_equal(got.numpy(), exp)
    np.testing.assert_array_equal(got.numpy(), oracle)
    assert 0 < oracle.sum() < oracle.shape[0]
    _assert_matrix_route(formulation, "validate")


# ------------------------------------------------- re-basing a seed
def _commit_some(init, dirty, gv):
    """A store whose ``dirty`` addresses were rewritten after a snapshot
    at ``gv`` (values +1, versions gv + 1..), as numpy arrays."""
    values, versions = init.copy(), np.zeros(init.shape[0], np.int32)
    values[dirty] += 1
    versions[dirty] = gv + 1 + np.arange(len(dirty))
    return values, versions, np.int32(gv + len(dirty))


@pytest.mark.parametrize("n_dirty", [1, 40], ids=["compact-rung",
                                                   "full-rung"])
def test_seed_round_state_equals_fresh_round_0(n_dirty, formulation):
    k, n_obj = 64, 256
    wl = _wl(W, k, 7, skew=0.0, n_objects=n_obj, device="cpu")
    ref_wl = _wl(ref_W, k, 7, skew=0.0, n_objects=n_obj)
    init = _init(1, n_obj)
    dirty = np.random.default_rng(n_dirty).choice(n_obj, n_dirty,
                                                  replace=False)
    values, versions, gv = _commit_some(init, dirty, 0)

    snap = make_store(n_obj, init=init, device="cpu")
    seed = protocol.spec_execute(snap, wl.batch)
    now = store_with(snap, torch.from_numpy(values),
                     torch.from_numpy(versions), torch.tensor(gv))
    rs, n_inv, spec_rounds = protocol.seed_round_state(wl.batch, now, seed)
    fresh = protocol.refresh_round_state(
        protocol.init_round_state(wl.batch, now.values, now.versions),
        wl.batch, wl.batch.n_ins > 0)
    assert_results_equal(rs.res, fresh.res, "seed vs fresh")
    for f in ("conflict", "foot_bits", "write_bits"):
        a, b = getattr(rs, f), getattr(fresh, f)
        assert (a is None) == (b is None) == (formulation[0] == "scatter")
        if a is not None:
            assert torch.equal(a, b), f
    assert int(rs.live.sum()) == int(rs.live_txns) == 0
    assert int(rs.walked_slots) == 0
    # the state owns a copy of the image
    assert torch.equal(rs.values, now.values)
    assert rs.values.data_ptr() != now.values.data_ptr()

    ref_snap = ref_make_store(n_obj, init=init)
    ref_seed = ref_protocol.spec_execute(ref_snap, ref_wl.batch)
    ref_now = ref_store_with(ref_snap, jnp.asarray(values),
                             jnp.asarray(versions), jnp.asarray(gv))
    ref_rs, ref_inv, ref_rounds = ref_protocol.seed_round_state(
        ref_wl.batch, ref_now, ref_seed)
    assert_results_equal(seed.res, ref_seed.res, "spec_execute")
    assert_results_equal(rs.res, ref_rs.res, "seed_round_state")
    assert int(n_inv) == int(ref_inv) and int(spec_rounds) == int(ref_rounds)
    assert 0 < int(n_inv) < k
    assert n_inv.dtype == spec_rounds.dtype == torch.int32
    _assert_matrix_route(formulation, "validate", "delta")


def test_seed_round_state_takes_one_rung(monkeypatch):
    """The re-execution runs at the narrowest rung of the ladder that
    holds the invalidated rows, and nowhere when none is invalid."""
    k, n_obj = 64, 256
    wl = _wl(W, k, 7, skew=0.0, n_objects=n_obj, device="cpu")
    init = _init(1, n_obj)
    snap = make_store(n_obj, init=init, device="cpu")
    seed = protocol.spec_execute(snap, wl.batch)
    rungs = []
    full, compact = (protocol.refresh_round_state,
                     protocol.refresh_round_state_compact)
    monkeypatch.setattr(protocol, "refresh_round_state",
                        lambda *a: rungs.append(k) or full(*a))
    monkeypatch.setattr(protocol, "refresh_round_state_compact",
                        lambda *a: rungs.append(a[3]) or compact(*a))
    for n_dirty in (0, 1, 40):
        dirty = np.random.default_rng(n_dirty).choice(n_obj, n_dirty,
                                                      replace=False)
        values, versions, gv = _commit_some(init, dirty, 0)
        now = store_with(snap, torch.from_numpy(values),
                         torch.from_numpy(versions), torch.tensor(gv))
        rungs.clear()
        _, n_inv, _ = protocol.seed_round_state(wl.batch, now, seed)
        n_inv = int(n_inv)
        ladder = protocol.compact_ladder(k)
        want = [] if n_inv == 0 else [
            ladder[0] if n_inv > ladder[1] else ladder[1]]
        assert rungs == want, (n_dirty, n_inv, rungs)


# --------------------------------------------- seeded engine entry points
@pytest.fixture(scope="module")
def ref_seeded():
    """The reference's seed of batch B against the store before batch A,
    and its unseeded and seeded runs of B on the store A left."""
    runs = {}

    def get(engine):
        if engine not in runs:
            eng = ref_get_engine(engine)
            a, b = _wl(ref_W, 24, 1), _wl(ref_W, 24, 2)
            store0 = ref_make_store(N_OBJ, init=_init())
            seed = ref_protocol.spec_execute(store0, b.batch)
            raw = jax.jit(eng.raw, static_argnums=(4,))
            raw_spec = jax.jit(eng.raw_spec, static_argnums=(4,))
            seq = lambda w: jnp.asarray(_seq(w.lanes.tolist()))
            lanes = lambda w: jnp.asarray(w.lanes, jnp.int32)
            store1, _ = raw(store0, a.batch, seq(a), lanes(a), N_LANES)
            plain = raw(store1, b.batch, seq(b), lanes(b), N_LANES)
            seeded = raw_spec(store1, b.batch, seq(b), lanes(b), N_LANES,
                              seed)
            runs[engine] = seed, plain, seeded
        return runs[engine]

    return get


def _port_args(w):
    return (torch.from_numpy(_seq(w.lanes.tolist())),
            torch.from_numpy(w.lanes.astype(np.int32)), N_LANES)


def _assert_stores_equal(port, ref):
    got = convert.store_to_numpy(port)
    for f in ("values", "versions", "gv"):
        np.testing.assert_array_equal(got[f], np.asarray(getattr(ref, f)))


@pytest.mark.parametrize("engine", ENGINES)
def test_seeded_equals_unseeded(engine, formulation, ref_seeded):
    eng = get_engine(engine)
    a, b = (_wl(W, 24, s, device="cpu") for s in (1, 2))
    store0 = make_store(N_OBJ, init=_init(), device="cpu")
    seed = protocol.spec_execute(store0, b.batch)
    store1, _ = eng.raw(store0, a.batch, *_port_args(a))
    plain_store, plain = eng.raw(store1, b.batch, *_port_args(b))
    seeded_store, seeded = eng.raw_spec(store1, b.batch, *_port_args(b),
                                        seed)
    _assert_stores_equal(seeded_store, plain_store)
    _assert_equal_but_spec([plain], [seeded], engine)
    assert int(seeded.spec_executed) == 24
    assert int(seeded.spec_invalidated) > 0 and int(seeded.spec_rounds) == 1

    _, (_, ref_plain), (ref_store, ref_trace) = ref_seeded(engine)
    assert_traces_equal([seeded], [ref_trace], f"{engine} seeded")
    assert_traces_equal([plain], [ref_plain], f"{engine} plain")
    _assert_stores_equal(seeded_store, ref_store)
    _assert_matrix_route(formulation, "validate")


@pytest.mark.parametrize("engine", ENGINES)
def test_seed_from_the_reference_drives_the_port(engine, ref_seeded):
    """A seed made by the reference, carried across as numpy, gives the
    port the reference's seeded store and trace."""
    ref_seed, _, (ref_store, ref_trace) = ref_seeded(engine)
    seed = convert.seed_from_numpy(ref_seed, device="cpu")
    assert convert.seed_to_numpy(seed)["conflict"] is None
    eng = get_engine(engine)
    a, b = (_wl(W, 24, s, device="cpu") for s in (1, 2))
    store1, _ = eng.raw(make_store(N_OBJ, init=_init(), device="cpu"),
                        a.batch, *_port_args(a))
    store2, trace = eng.raw_spec(store1, b.batch, *_port_args(b), seed)
    assert_traces_equal([trace], [ref_trace], engine)
    _assert_stores_equal(store2, ref_store)


# -------------------------------------------------- pipelined sessions
@pytest.fixture(scope="module")
def ref_pipelined():
    runs = {}

    def get(engine, depth):
        if (engine, depth) not in runs:
            batches, lanes = _stream(ref_W)
            s = RefSession(N_OBJ, engine=engine, n_lanes=N_LANES,
                           pipeline_depth=depth)
            traces = s.run_stream(batches, lanes)
            runs[engine, depth] = (s.fingerprint(), s.replay_log(),
                                   traces)
        return runs[engine, depth]

    return get


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("engine", ENGINES)
def test_pipelined_session_matches_serial_and_reference(
        engine, depth, formulation, ref_pipelined):
    batches, lanes = _stream(W, device="cpu")
    serial = PotSession(N_OBJ, engine=engine, n_lanes=N_LANES, device="cpu")
    t0 = serial.run_stream(batches, lanes)
    piped = PotSession(N_OBJ, engine=engine, n_lanes=N_LANES,
                       pipeline_depth=depth, device="cpu")
    t1 = piped.run_stream(batches, lanes)
    assert piped.fingerprint() == serial.fingerprint()
    assert piped.replay_log() == serial.replay_log()
    _assert_equal_but_spec(t0, t1, f"{engine} D={depth}")
    assert sum(int(t.spec_executed) for t in t1) > 0
    assert int(t1[0].spec_rounds) == 0   # speculated on its own store
    assert piped.bucket_counts() == serial.bucket_counts()
    assert piped.compile_count() == 2 and not piped._window

    fp, log, ref_traces = ref_pipelined(engine, depth)
    assert piped.fingerprint() == fp and piped.replay_log() == log
    assert_traces_equal(t1, ref_traces, f"{engine} D={depth}")
    _assert_matrix_route(formulation, "validate")


def _seed_arrays(seed):
    out = convert.seed_to_numpy(seed)
    return {**{f"res.{k}": v for k, v in out.pop("res").items()}, **out}


def test_a_waiting_seed_owns_its_tensors(formulation):
    """Enqueue two batches, drain the first: the second's seed still
    equals a fresh speculation against the store it was made on."""
    batches, lanes = _stream(W, device="cpu")
    s = PotSession(N_OBJ, engine="pcc", n_lanes=N_LANES, pipeline_depth=2,
                   device="cpu")
    for b, l in zip(batches[:2], lanes[:2]):
        s._spec_enqueue(b, s.sequencer.order_for(l.tolist()), l)
    before = store_with(s.store, s.store.values.clone(),
                        s.store.versions.clone(), s.store.gv.clone())
    waiting = s._window[1]
    s._spec_drain()
    assert int(s.store.gv) > int(before.gv)
    again = protocol.spec_execute(before, waiting[0])
    got, exp = _seed_arrays(waiting[3]), _seed_arrays(again)
    assert got.keys() == exp.keys()
    for key in got:
        if exp[key] is None:
            assert got[key] is None, key
        else:
            np.testing.assert_array_equal(got[key], exp[key], err_msg=key)
    assert waiting[3].snap_gv.data_ptr() != s.store.gv.data_ptr()
    s._spec_flush()


def test_submit_flushes_the_window():
    batches, lanes = _stream(W, device="cpu")
    s = PotSession(N_OBJ, engine="pcc", n_lanes=N_LANES, pipeline_depth=2,
                   device="cpu")
    s._spec_enqueue(batches[0], s.sequencer.order_for(lanes[0].tolist()),
                    lanes[0])
    trace = s.submit(batches[1], lanes[1])
    assert not s._window and len(s.traces) == 2 and s.traces[1] is trace
    assert int(s.traces[0].spec_executed) == STREAM_K[0]
    assert int(trace.spec_executed) == 0     # submit is the serial step
    serial = PotSession(N_OBJ, engine="pcc", n_lanes=N_LANES, device="cpu")
    serial.run_stream(batches[:2], lanes[:2])
    assert s.fingerprint() == serial.fingerprint()
    assert s.replay_log() == serial.replay_log()


def test_depth_zero_and_unseeded_engines_take_the_serial_path():
    batches, lanes = _stream(W, device="cpu")
    serial = PotSession(N_OBJ, n_lanes=N_LANES, device="cpu")
    t0 = serial.run_stream(batches, lanes)
    assert not serial._pipelined
    assert all(int(t.spec_executed) == 0 for t in t0)
    pcc = get_engine("pcc")
    plain = EngineDef("pcc-unseeded", pcc.raw)
    s = PotSession(N_OBJ, engine=plain, n_lanes=N_LANES, pipeline_depth=2,
                   device="cpu")
    t1 = s.run_stream(batches, lanes)
    assert not s._pipelined and not s._window
    _assert_equal_but_spec(t0, t1)
    assert all(int(t.spec_executed) == 0 for t in t1)


def test_pipelined_replay_round_trip():
    batches, lanes = _stream(W, device="cpu")
    s = PotSession(N_OBJ, engine="pcc", n_lanes=N_LANES, pipeline_depth=1,
                   device="cpu")
    s.run_stream(batches, lanes)
    replay = PotSession(N_OBJ, engine="pcc", pipeline_depth=2,
                        sequencer=s.replay_sequencer(), device="cpu")
    replay.run_stream(batches)
    assert replay.fingerprint() == s.fingerprint()
    assert replay.replay_log() == s.replay_log()


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 10_000), st.sampled_from([1, 2]),
       st.sampled_from(ENGINES),
       st.one_of(st.just(0.0), st.floats(1e-6, 1.5)))
def test_pipelined_equals_serial_property(seed, depth, engine, skew):
    batches, lanes = _stream(W, seed=seed, skew=skew, device="cpu")
    s0 = PotSession(N_OBJ, engine=engine, n_lanes=N_LANES, device="cpu")
    t0 = s0.run_stream(batches, lanes)
    s1 = PotSession(N_OBJ, engine=engine, n_lanes=N_LANES,
                    pipeline_depth=depth, device="cpu")
    t1 = s1.run_stream(batches, lanes)
    assert s0.fingerprint() == s1.fingerprint()
    assert s0.replay_log() == s1.replay_log()
    _assert_equal_but_spec(t0, t1, f"{engine} D={depth} skew={skew}")


def test_core_exports_match_the_reference_but_items_9_and_10():
    """``repro_torch.core`` exports every name ``repro.core`` does, those
    of the sharded store and of checkpoints (queue 1 items 9-10) among
    them; the ``Engine`` protocol, ``DenseStore`` and ``ExecTrace.waves``
    are the reference's."""
    import repro.core as ref_core
    import repro_torch.core as core
    assert set(ref_core.__all__) - set(core.__all__) == set()
    assert {"ShardedStore", "run_replica", "trace_digest"} <= set(
        core.__all__)
    assert all(isinstance(get_engine(e), core.Engine) for e in ENGINES)
    assert core.DenseStore is core.TStore
    batches, lanes = _stream(W, device="cpu")
    s = PotSession(N_OBJ, engine="occ", n_lanes=N_LANES, device="cpu")
    trace = s.submit(batches[0], lanes[0])
    assert trace.waves is trace.rounds
    assert s.compile_count() == len(s.bucket_counts()) == 1
