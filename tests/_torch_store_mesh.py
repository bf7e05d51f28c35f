"""One store shard per rank (``mesh=``) in the port against the
reference's own mesh run, shared by ``tests/test_torch_store_mesh.py``.

The reference runs in one subprocess (:func:`reference_main`) with 8
host devices and 1-D ``("shard",)`` meshes of ``Auto`` axes (jax 0.9's
``make_mesh`` makes ``Explicit`` ones by default, which its sharded
write-back rejects); the port runs on 8 gloo ranks beside it
(``_torch_dist.store_mesh_worker``), each rank in 1-D meshes of 1, 2
and 8 ranks cut from one 2-D mesh.  Both build the same workloads from
the same seeds: the reference test's ``counters`` batch
(``tests/test_sharded_store.py``) and one vacation-like batch."""

import dataclasses
import os
import pathlib
import pickle
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORLD = 8
SIZES = (1, 2, 8)            # the meshes' ranks
ENGINES = ("pcc", "pogl", "destm", "occ")
# (workload, mesh size) of PCC held against the reference's mesh run
RUNS = (("counters", 1), ("counters", 2), ("counters", 8), ("vacation", 8))
# the meshes the engines run on against the dense session, by depth
ENGINE_SIZES = {0: (2, 8), 2: (8,)}
COUNTERS = dict(n_txns=24, n_objects=80, n_reads=2, n_writes=2, n_lanes=4,
                skew=0.9, seed=6)
VACATION = dict(n_txns=64, n_objects=1024, n_lanes=8, seed=3)


def workloads(W, **kw) -> dict:
    """The two workloads from a package's ``workloads`` module."""
    return {"counters": W.counters(**COUNTERS, **kw),
            "vacation": W.vacation_like(**VACATION, **kw)}


def trace_arrays(trace) -> dict:
    import numpy as np
    return {f.name: np.array(getattr(trace, f.name))
            for f in dataclasses.fields(trace)}


def reference_main(out):
    """The reference's PCC on ``shard_store(dense, s, mesh=)`` for each
    (workload, mesh size) of ``RUNS``, and a ``PotSession(shards=8, mesh=)`` over
    the counters batch; pickled to ``out``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType

    from repro.core import (PotSession, RoundRobinSequencer, fingerprint,
                            make_store, pcc_execute, shard_store)
    from repro.core import workloads as W

    def mesh(s):
        return jax.make_mesh((s,), ("shard",), devices=jax.devices()[:s],
                             axis_types=(AxisType.Auto,))

    result = {}
    wls = workloads(W)
    for name, s in RUNS:
        wl = wls[name]
        seq = jnp.asarray(RoundRobinSequencer(n_root_lanes=wl.n_lanes)
                          .order_for(wl.lanes.tolist()), jnp.int32)
        dense = make_store(wl.n_objects)
        store, trace = pcc_execute(shard_store(dense, s, mesh=mesh(s)),
                                   wl.batch, seq)
        result[(name, s)] = dict(fingerprint=int(fingerprint(store)),
                                 trace=trace_arrays(trace))
    wl = wls["counters"]
    sess = PotSession(wl.n_objects, engine="pcc", n_lanes=wl.n_lanes,
                      shards=8, mesh=mesh(8))
    trace = sess.submit(wl.batch, wl.lanes.tolist())
    result["session"] = dict(fingerprint=int(sess.fingerprint()),
                             replay=sess.replay_log(),
                             trace=trace_arrays(trace))
    with open(out, "wb") as f:
        pickle.dump(result, f)


def run_port(tmp_path, part) -> list:
    """The port's 8 ranks on ``part`` of ``_torch_dist.store_mesh_worker``:
    each rank's results."""
    import _torch_dist
    _torch_dist.spawn(_torch_dist.store_mesh_worker, WORLD, tmp_path / "rdv",
                      str(tmp_path / "snaps"), str(tmp_path / "port"), part)
    ranks = []
    for r in range(WORLD):
        with open(tmp_path / f"port.{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return ranks


def run_both(tmp_path) -> tuple[dict, list]:
    """The reference's subprocess and the port's 8 ranks ("reference"
    part) side by side: (the reference's results, each rank's)."""
    ref_out = tmp_path / "ref.pkl"
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")]),
        "XLA_FLAGS": f"--xla_force_host_platform_device_count={WORLD}",
        "JAX_PLATFORMS": "cpu"}
    ref = subprocess.Popen(
        [sys.executable, "-c", "import sys, _torch_store_mesh as m; "
         "m.reference_main(sys.argv[1])", str(ref_out)], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ranks = run_port(tmp_path, "reference")
    finally:
        _, err = ref.communicate(timeout=600)
    assert ref.returncode == 0, err[-3000:]
    with open(ref_out, "rb") as f:
        ref_result = pickle.load(f)
    return ref_result, ranks
