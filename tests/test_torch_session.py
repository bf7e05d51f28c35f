"""The port's main path end to end against the JAX reference: ragged
streams of ``counters`` and ``vacation_like`` batches through both
``PotSession``s, under both bucket ladders, must give bitwise-equal
``fingerprint()``, ``replay_log()``, store images and every
``ExecTrace`` field.

Each comparison runs twice: on the port's CPU path (the scatter-min
formulation) and with ``ops._on_cuda`` patched to True, so that the
matrix formulation the card takes (packed bitsets, the delta kernel at
the full rung, the pair kernel's strips at the compact rungs) runs
through the kernels' plain versions and is held to the reference too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from _torch_parity import assert_traces_equal

from repro.core import workloads as ref_W
from repro.core.pcc import pcc_execute as ref_pcc_execute
from repro.core.sequencer import RoundRobinSequencer
from repro.core.session import PotSession as RefSession
from repro.core.tstore import make_store as ref_make_store
from repro_torch import convert
from repro_torch.core import oracle
from repro_torch.core import workloads as W
from repro_torch.core.pcc import pcc_execute
from repro_torch.core.session import PotSession
from repro_torch.core.tstore import make_store
from repro_torch.kernels import conflict, ops

RAGGED_K = (5, 17, 12)   # pow2 buckets 8, 32, 16; dense 8, 24, 16
N_LANES = 4


def _workload(pkg, name, k, seed, **kw):
    if name == "counters":
        return pkg.counters(n_txns=k, n_objects=48, n_reads=2, n_writes=2,
                            n_lanes=N_LANES, skew=0.8, seed=seed, **kw)
    return pkg.vacation_like(n_txns=k, n_objects=128, n_lanes=N_LANES,
                             seed=seed, **kw)


def _stream(pkg, name, **kw):
    return [_workload(pkg, name, k, seed, **kw)
            for seed, k in enumerate(RAGGED_K)]


@pytest.fixture(scope="module")
def reference_run():
    runs = {}

    def get(name, ladder):
        if (name, ladder) not in runs:
            wls = _stream(ref_W, name)
            s = RefSession(wls[0].n_objects, engine="pcc", n_lanes=N_LANES,
                           bucket_ladder=ladder)
            traces = s.run_stream([w.batch for w in wls],
                                  [w.lanes for w in wls])
            runs[name, ladder] = dict(
                session=s, traces=traces, fingerprint=s.fingerprint(),
                replay_log=s.replay_log(),
                values=np.asarray(s.store.values),
                versions=np.asarray(s.store.versions), gv=int(s.store.gv))
        return runs[name, ladder]

    return get


@pytest.fixture(params=["scatter", "matrix"])
def formulation(request, monkeypatch):
    """Counts the kernel-wrapper calls; ``matrix`` forces the card's
    formulation on CPU tensors.  The streams are contended enough that
    every batch bucketed at 24 or 32 reaches the compact rung, so a
    matrix run calls both wrappers."""
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


def _assert_formulation_used(formulation):
    kind, calls = formulation
    if kind == "matrix":
        assert calls["delta"] > 0 and calls["pair"] > 0, calls
    else:
        assert calls == {"pair": 0, "delta": 0}


@pytest.mark.parametrize("ladder", ["pow2", "dense"])
@pytest.mark.parametrize("name", ["counters", "vacation"])
def test_stream_matches_reference(name, ladder, formulation, reference_run):
    ref = reference_run(name, ladder)
    wls = _stream(W, name, device="cpu")
    s = PotSession(wls[0].n_objects, engine="pcc", n_lanes=N_LANES,
                   bucket_ladder=ladder, device="cpu")
    traces = s.run_stream([w.batch for w in wls], [w.lanes for w in wls])
    assert s.fingerprint() == ref["fingerprint"]
    assert s.replay_log() == ref["replay_log"]
    assert_traces_equal(traces, ref["traces"], f"{name}/{ladder}")
    np.testing.assert_array_equal(s.store.values.numpy(), ref["values"])
    np.testing.assert_array_equal(s.store.versions.numpy(), ref["versions"])
    assert s.gv == ref["gv"] == sum(RAGGED_K)
    assert s.bucket_counts() == ref["session"].bucket_counts()
    for a, b in zip(s.live_counts(), ref["session"].live_counts()):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(s.wave_counts(), ref["session"].wave_counts()):
        np.testing.assert_array_equal(a, b)
    _assert_formulation_used(formulation)


def test_stream_matches_serial_oracle():
    wls = _stream(W, "vacation", device="cpu")
    s = PotSession(wls[0].n_objects, engine="pcc", n_lanes=N_LANES,
                   device="cpu")
    s.run_stream([w.batch for w in wls], [w.lanes for w in wls])
    seqr = RoundRobinSequencer(n_root_lanes=N_LANES)
    values, versions, gv = oracle.serial_execute(
        np.zeros((wls[0].n_objects, 1), np.int32),
        np.zeros(wls[0].n_objects, np.int32), 0,
        [convert.batch_to_numpy(w.batch) for w in wls],
        [seqr.order_for(w.lanes.tolist()) for w in wls])
    np.testing.assert_array_equal(s.store.values.numpy(), values)
    np.testing.assert_array_equal(s.store.versions.numpy(), versions)
    assert s.gv == gv


def test_replay_sequencer_reproduces_the_stream():
    wls = _stream(W, "counters", device="cpu")
    batches, lanes = [w.batch for w in wls], [w.lanes for w in wls]
    s = PotSession(48, engine="pot", n_lanes=N_LANES, device="cpu")
    s.run_stream(batches, lanes)
    replay = PotSession(48, engine="pcc", sequencer=s.replay_sequencer(),
                        device="cpu")
    replay.run_stream(batches)
    assert replay.fingerprint() == s.fingerprint()
    assert replay.replay_log() == s.replay_log()


_PCC_CASES = [
    dict(incremental=True, compact=True),
    dict(incremental=True, compact=False),
    dict(incremental=False, compact=True),
    dict(incremental=False, compact=False),
    dict(live_promotion=False),
    dict(max_rounds=3),
]


@pytest.fixture(scope="module")
def pcc_reference():
    """The batch, its sequence, an initial image, and the reference's
    result for each case (computed once per case)."""
    wl = ref_W.vacation_like(n_txns=24, n_objects=128, n_lanes=4, seed=3)
    seq = np.asarray(RoundRobinSequencer(n_root_lanes=4).order_for(
        wl.lanes.tolist()), np.int32)
    init = np.random.default_rng(0).integers(-50, 50, (128, 1)).astype(
        np.int32)
    runs = {}

    def get(kw):
        key = tuple(sorted(kw.items()))
        if key not in runs:
            runs[key] = ref_pcc_execute(ref_make_store(128, init=init),
                                        wl.batch, jnp.asarray(seq), **kw)
        return seq, init, runs[key]

    return get


@pytest.mark.parametrize("kw", _PCC_CASES,
                         ids=lambda kw: "-".join(f"{k}={v}"
                                                 for k, v in kw.items()))
def test_pcc_execute_matches_reference(kw, formulation, pcc_reference):
    seq, init, (ref_store, ref_trace) = pcc_reference(kw)
    wl = W.vacation_like(n_txns=24, n_objects=128, n_lanes=4, seed=3,
                         device="cpu")
    store = make_store(128, init=init, device="cpu")
    out, trace = pcc_execute(store, wl.batch, torch.from_numpy(seq), **kw)
    assert_traces_equal([trace], [ref_trace], str(kw))
    for f in ("values", "versions", "gv"):
        np.testing.assert_array_equal(getattr(out, f).numpy(),
                                      np.asarray(getattr(ref_store, f)))
    # the input store is left as it was
    np.testing.assert_array_equal(store.values.numpy(), init)
    kind, calls = formulation
    if kind == "matrix":
        assert calls["delta"] > 0


@pytest.mark.parametrize("kw", [dict(pipeline_depth=1), dict(shards=2),
                                dict(elastic=object()), dict(engine="occ")])
def test_unported_session_arguments_raise(kw):
    with pytest.raises(NotImplementedError):
        PotSession(16, device="cpu", **kw)


def test_unported_session_methods_raise():
    s = PotSession(16, device="cpu")
    with pytest.raises(NotImplementedError):
        s.serve(None)
    with pytest.raises(NotImplementedError):
        s.snapshot("unused")
