"""One store shard per rank (``mesh=``, the reference's ``shard_map``
placement) on 8 gloo ranks against the reference's own mesh run on 8
host devices (``tests/_torch_store_mesh.py``), bitwise: PCC on
``shard_store(dense, s, mesh=)`` over the reference test's ``counters``
batch on meshes of 1, 2 and 8 ranks and over a vacation-like batch on 8
(the store fingerprint and every ``ExecTrace`` field), and
``PotSession(shards=8, mesh=)`` (fingerprint, ``replay_log()``, trace).
A wrong-sized mesh raises ``ValueError``.  The engines against the
dense session and the snapshots are in
``tests/test_torch_store_mesh_engines.py``."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import _torch_store_mesh as sm

from repro.core import workloads as ref_W
from repro_torch import convert
from repro_torch.core import workloads as W
from repro_torch.core.engine import TRACE_FIELDS


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return sm.run_both(tmp_path_factory.mktemp("store_mesh"))


def assert_trace(port: dict, ref: dict, msg=""):
    for f in TRACE_FIELDS:
        np.testing.assert_array_equal(port[f], ref[f], err_msg=f"{msg} {f}")


def test_workloads_are_the_reference_batches():
    ref, port = sm.workloads(ref_W), sm.workloads(W, device="cpu")
    for name in ref:
        got = convert.batch_to_numpy(port[name].batch)
        for f, a in got.items():
            np.testing.assert_array_equal(a, np.asarray(
                getattr(ref[name].batch, f)), err_msg=f"{name} {f}")
        np.testing.assert_array_equal(port[name].lanes, ref[name].lanes)


@pytest.mark.parametrize("name,s", sm.RUNS)
def test_pcc_on_a_mesh_matches_the_reference_mesh_run(runs, name, s):
    ref_result, ranks = runs
    exp = ref_result[(name, s)]
    for got in ranks:
        run = got[(name, s)]
        assert run["fingerprint"] == exp["fingerprint"]
        assert_trace(run["trace"], exp["trace"], f"{name} s={s}")


def test_session_on_a_mesh_matches_the_reference_mesh_run(runs):
    ref_result, ranks = runs
    exp = ref_result["session"]
    for got in ranks:
        run = got["session"]
        assert run["fingerprint"] == exp["fingerprint"]
        assert run["replay"] == exp["replay"]
        assert_trace(run["trace"], exp["trace"], "session")


def test_wrong_sized_meshes_raise(runs):
    _, ranks = runs
    for got in ranks:
        for tag, msg in got["refusals"].items():
            assert msg is not None and "mesh must have exactly one axis" \
                in msg, tag
