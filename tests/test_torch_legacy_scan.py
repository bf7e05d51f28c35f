"""The port's frozen scan oracle (``repro_torch.core.legacy_scan``)
against the reference's (``repro.core.legacy_scan``) and against the
port's vectorized engines, bitwise.

The workloads are ``tests/test_commit_pipeline.py``'s, drawn by the
reference's generators and carried across as numpy.  Each oracle is held
to the reference's oracle on the store (values, versions, gv) and every
``ExecTrace`` field, from a fresh store and from one with a random image
and gv 5 (so the gv-rebased version stamps show), and under the round
caps; and to the port's engine in the store and the trace fields the
reference's own equivalence tests compare.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from _torch_parity import assert_traces_equal, ref_batch

from repro.core import legacy_scan as ref_scan
from repro.core import workloads as ref_W
from repro.core.sequencer import RoundRobinSequencer
from repro.core.tstore import TStore as RefStore
from repro_torch import convert
from repro_torch.core import legacy_scan
from repro_torch.core.destm import destm_execute
from repro_torch.core.occ import occ_execute
from repro_torch.core.pcc import pcc_execute

WORKLOADS = [
    ref_W.counters(n_txns=1, n_objects=8, n_reads=1, n_writes=1, n_lanes=1,
                   skew=0.0, seed=0),
    ref_W.counters(n_txns=2, n_objects=2, n_reads=1, n_writes=2, n_lanes=2,
                   skew=0.0, seed=1),
    ref_W.counters(n_txns=64, n_objects=32, n_reads=2, n_writes=2,
                   n_lanes=8, skew=1.0, seed=2),
    ref_W.vacation_like(n_txns=24, n_objects=128, n_lanes=4, seed=3),
    ref_W.labyrinth_like(n_txns=8, n_objects=64, path_len=8, n_lanes=4,
                         seed=6),
    ref_W.ssca2_like(n_txns=24, n_objects=512, n_lanes=8, seed=5),
]
IDS = [f"{w.name}-k{w.batch.n_txns}" for w in WORKLOADS]


def _case(wl, gv0):
    """numpy store, batch, seq, lanes and arrival of one workload."""
    k = wl.batch.n_txns
    n = wl.n_objects
    if gv0:
        values = np.random.default_rng(n).integers(
            -50, 50, (n, 1)).astype(np.int32)
        versions = np.random.default_rng(k).integers(
            0, gv0 + 1, (n,)).astype(np.int32)
    else:
        values, versions = np.zeros((n, 1), np.int32), np.zeros(n, np.int32)
    store = dict(values=values, versions=versions, gv=np.int32(gv0))
    seq = np.asarray(RoundRobinSequencer(n_root_lanes=wl.n_lanes).order_for(
        wl.lanes.tolist()), np.int32)
    arrival = np.random.default_rng(k).permutation(k).astype(np.int32)
    batch = {f: np.asarray(getattr(wl.batch, f)) for f in
             ("opcodes", "addrs", "indirect", "operands", "n_ins")}
    return store, batch, seq, np.asarray(wl.lanes, np.int32), arrival


def _runs(name, store, batch, seq, lanes, arrival, **kw):
    """The reference's oracle and the port's on the same inputs."""
    rstore = RefStore(**{f: jnp.asarray(a) for f, a in store.items()})
    pstore = convert.store_from_numpy(store, device="cpu")
    pbatch = convert.batch_from_numpy(batch, device="cpu")
    t = lambda a: torch.from_numpy(a)
    if name == "pcc":
        ref = ref_scan.pcc_execute_scan(rstore, ref_batch(batch),
                                        jnp.asarray(seq), **kw)
        got = legacy_scan.pcc_execute_scan(pstore, pbatch, t(seq), **kw)
    elif name == "occ":
        ref = ref_scan.occ_execute_scan(rstore, ref_batch(batch),
                                        jnp.asarray(arrival), **kw)
        got = legacy_scan.occ_execute_scan(pstore, pbatch, t(arrival), **kw)
    else:
        n_lanes = int(lanes.max()) + 1
        ref = ref_scan.destm_execute_scan(rstore, ref_batch(batch),
                                          jnp.asarray(seq),
                                          jnp.asarray(lanes), n_lanes, **kw)
        got = legacy_scan.destm_execute_scan(pstore, pbatch, t(seq),
                                             t(lanes), n_lanes, **kw)
    return got, ref


def _assert_store_equal(got, ref, msg):
    g = convert.store_to_numpy(got)
    for f in ("values", "versions", "gv"):
        np.testing.assert_array_equal(g[f], np.asarray(getattr(ref, f)),
                                      err_msg=f"{msg} store.{f}")


@pytest.mark.parametrize("gv0", [0, 5])
@pytest.mark.parametrize("name", ["pcc", "occ", "destm"])
@pytest.mark.parametrize("wl", WORKLOADS, ids=IDS)
def test_scan_matches_reference_scan(wl, name, gv0):
    case = _case(wl, gv0)
    variants = [{"live_promotion": True}, {"live_promotion": False}] \
        if name == "pcc" else [{}]
    for kw in variants:
        (store, trace), (rstore, rtrace) = _runs(name, *case, **kw)
        _assert_store_equal(store, rstore, f"{name} {kw}")
        assert_traces_equal([trace], [rtrace], f"{name} {kw}")


@pytest.mark.parametrize("name,kw", [
    ("pcc", {"max_rounds": 2}), ("pcc", {"max_rounds": 0}),
    ("pcc", {"max_rounds": 3, "live_promotion": False}),
    ("occ", {"max_waves": 1}), ("destm", {"max_rounds": 2}),
])
def test_round_caps_match_reference_scan(name, kw):
    """The cap semantics (``max_rounds`` / ``max_waves``; the default
    limit is K + 1) on the contended counters workload, where the caps
    leave transactions uncommitted."""
    case = _case(WORKLOADS[2], 5)
    (store, trace), (rstore, rtrace) = _runs(name, *case, **kw)
    _assert_store_equal(store, rstore, f"{name} {kw}")
    assert_traces_equal([trace], [rtrace], f"{name} {kw}")
    done = trace.commit_pos if name == "occ" else trace.commit_round
    assert int((done >= 0).sum()) < WORKLOADS[2].batch.n_txns


PIPELINE_FIELDS = {
    "pcc": ["commit_pos", "mode", "retries", "commit_round", "first_round",
            "wait_rounds", "rounds", "exec_ops", "validation_words",
            "promotions"],
    "occ": ["commit_pos", "retries", "commit_round", "rounds", "exec_ops"],
    "destm": ["commit_pos", "retries", "commit_round", "first_round",
              "rounds", "exec_ops", "barrier_ops"],
}


@pytest.mark.parametrize("name", ["pcc", "occ", "destm"])
@pytest.mark.parametrize("wl", WORKLOADS, ids=IDS)
def test_engines_equal_the_scan(wl, name):
    """The port's vectorized engine equals the port's oracle in the store
    and the fields ``tests/test_commit_pipeline.py`` compares."""
    store, batch, seq, lanes, arrival = _case(wl, 0)
    pstore = convert.store_from_numpy(store, device="cpu")
    pbatch = convert.batch_from_numpy(batch, device="cpu")
    t = lambda a: torch.from_numpy(a)
    if name == "pcc":
        pairs = [(legacy_scan.pcc_execute_scan(pstore, pbatch, t(seq),
                                               live_promotion=lp),
                  pcc_execute(pstore, pbatch, t(seq), live_promotion=lp))
                 for lp in (True, False)]
    elif name == "occ":
        pairs = [(legacy_scan.occ_execute_scan(pstore, pbatch, t(arrival)),
                  occ_execute(pstore, pbatch, t(arrival)))]
    else:
        n_lanes = int(lanes.max()) + 1
        pairs = [(legacy_scan.destm_execute_scan(pstore, pbatch, t(seq),
                                                 t(lanes), n_lanes),
                  destm_execute(pstore, pbatch, t(seq), t(lanes), n_lanes))]
    for (old, t_old), (new, t_new) in pairs:
        for f in ("values", "versions", "gv"):
            assert torch.equal(getattr(old, f), getattr(new, f)), f
        for f in PIPELINE_FIELDS[name]:
            assert torch.equal(getattr(t_old, f), getattr(t_new, f)), \
                f"{name}: trace field {f!r} diverged from the scan"
