"""One store shard per rank (``mesh=``) on 8 gloo ranks against the
port's dense session (``tests/_torch_store_mesh.py``), bitwise: all four
engines over a stream of two ``counters`` batches on meshes of 2 and 8
ranks at depth 0 and pipelined at depth 2 on 8 (store fingerprint,
``replay_log()``, every ``ExecTrace`` field, the speculation's count),
and snapshots crossing layouts: one written on 8 ranks restores into the
dense store and a dense one into 8 ranks, and each serves the next batch
as the uninterrupted sessions do; ``run_replica(shards=8, mesh=)``
killed after its third batch and resumed from its last snapshot ends
with the dense replica's store and replay log."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import _torch_store_mesh as sm

from repro_torch.core.engine import TRACE_FIELDS


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return sm.run_port(tmp_path_factory.mktemp("store_mesh_engines"),
                       "engines")


def assert_trace(port: dict, ref: dict, msg=""):
    for f in TRACE_FIELDS:
        np.testing.assert_array_equal(port[f], ref[f], err_msg=f"{msg} {f}")


@pytest.mark.parametrize("depth", (0, 2))
@pytest.mark.parametrize("engine", sm.ENGINES)
def test_engines_on_a_mesh_equal_the_dense_session(ranks, engine, depth):
    for got in ranks:
        dense = got[("engine", engine, depth, 0)]
        if depth:
            assert dense["spec"] > 0
        for s in sm.ENGINE_SIZES[depth]:
            run = got[("engine", engine, depth, s)]
            assert run["fingerprint"] == dense["fingerprint"], s
            assert run["replay"] == dense["replay"], s
            assert run["spec"] == dense["spec"], s
            for a, b in zip(run["traces"], dense["traces"], strict=True):
                assert_trace(a, b, f"{engine} depth {depth} s={s}")


def test_snapshots_cross_between_eight_ranks_and_the_dense_store(ranks):
    for got in ranks:
        snap = got["snapshots"]
        assert snap["dense_layout"] == ("TStore", 1)
        assert snap["back_layout"] == ("ShardedStore", 8, (1, 10, 1))
        assert len(set(snap["fingerprints"])) == 1
        assert all(r == snap["replays"][0] for r in snap["replays"])
        for img in snap["images"][1:]:
            for k, a in img.items():
                np.testing.assert_array_equal(a, snap["images"][0][k])




def test_replica_on_eight_ranks_resumes_as_the_dense_replica(ranks):
    for got in ranks:
        rep = got["replica"]
        assert rep["restored_from"] >= 0 and rep["layout"] == 8
        assert rep["fingerprints"][0] == rep["fingerprints"][1]
        assert rep["replays"][0] == rep["replays"][1]
