"""The sharded store in the port against the JAX reference and against
the port's dense store, bitwise.

The shard decomposition: with the address space cut into S contiguous
range shards, conflict(t, u) is the OR over shards of per-shard
conflicts, write-back splits into S independent scatters, and every
decision stays in global rank space, so S changes no outcome.  Layers:

* the layout: round trips, the address map, padding left out of the
  fingerprint, a flat image that is a view of the shards;
* the ``*_sharded`` twins in ``kernels.ops`` (packed words, the
  OR-reduced table, the delta, the compact strips, the cross-batch
  validation) against the reference's twins and the dense verdicts, on
  the same numpy inputs;
* ``fused_write_back`` / ``apply_writes`` against the dense scatter;
* each engine at S in {2, 8} against the reference's sharded run and
  the port's dense run, in the store and every trace field;
* ``PotSession(shards=S)`` streams, replay and pipelining at depth 2.

A sharded store takes the matrix formulation on the CPU too: its
conflict questions go through the pair and delta kernels' plain
versions, never the scatter-min formulation.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from _hypothesis_compat import given, settings, st
from _torch_parity import assert_traces_equal, ref_result

from repro.core import destm_execute as ref_destm
from repro.core import occ_execute as ref_occ
from repro.core import pcc_execute as ref_pcc
from repro.core import workloads as ref_W
from repro.core.pogl import _pogl_raw as ref_pogl_raw
from repro.core.sequencer import RoundRobinSequencer
from repro.core.tstore import StoreLayout as RefLayout
from repro.core.tstore import fingerprint as ref_fingerprint
from repro.core.tstore import make_store as ref_make_store
from repro.core.tstore import shard_store as ref_shard_store
from repro.core.txn import gather_live_indices as ref_gather
from repro.kernels import ops as ref_ops
from repro_torch import convert
from repro_torch.core import protocol
from repro_torch.core import workloads as W
from repro_torch.core.engine import TRACE_FIELDS, get_engine
from repro_torch.core.session import PotSession
from repro_torch.core.tstore import (ShardedStore, StoreLayout, TStore,
                                     dense_image, fingerprint, flat_values,
                                     make_store, shard_images, shard_store,
                                     unshard_store)
from repro_torch.core.txn import gather_live_indices, run_all
from repro_torch.kernels import conflict, ops, validate

ENGINES = ("pcc", "occ", "destm", "pogl")
N_LANES = 4


def _wl(pkg, k, contention, seed, **kw):
    if contention == "low":
        return pkg.counters(n_txns=k, n_objects=max(64, 8 * k), n_reads=2,
                            n_writes=2, n_lanes=min(8, k), skew=0.0,
                            seed=seed, **kw)
    return pkg.counters(n_txns=k, n_objects=max(4, k // 4), n_reads=2,
                        n_writes=2, n_lanes=min(8, k), skew=1.0, seed=seed,
                        **kw)


def _seq(wl):
    return np.asarray(RoundRobinSequencer(n_root_lanes=wl.n_lanes).order_for(
        np.asarray(wl.lanes).tolist()), np.int32)


def _run(engine, store, wl, **kw):
    """One engine on the port; ``wl`` a port workload."""
    seq = torch.from_numpy(_seq(wl))
    lanes = torch.from_numpy(np.asarray(wl.lanes, np.int32))
    if kw:
        from repro_torch.core.destm import destm_execute
        from repro_torch.core.occ import occ_execute
        from repro_torch.core.pcc import pcc_execute
        if engine == "pcc":
            return pcc_execute(store, wl.batch, seq, **kw)
        if engine == "occ":
            return occ_execute(store, wl.batch,
                               torch.argsort(seq, stable=True), **kw)
        return destm_execute(store, wl.batch, seq, lanes, wl.n_lanes, **kw)
    return get_engine(engine).raw(store, wl.batch, seq, lanes, wl.n_lanes)


def _ref_run(engine, store, wl):
    seq = jnp.asarray(_seq(wl))
    lanes = jnp.asarray(wl.lanes, jnp.int32)
    if engine == "pcc":
        return ref_pcc(store, wl.batch, seq)
    if engine == "occ":
        return ref_occ(store, wl.batch, jnp.argsort(seq))
    if engine == "destm":
        return ref_destm(store, wl.batch, seq, lanes, wl.n_lanes)
    return ref_pogl_raw(store, wl.batch, seq, lanes, wl.n_lanes)


def _dense_np(store) -> dict:
    """values, versions and gv of either layout, from either package."""
    if isinstance(store, (TStore, ShardedStore)):
        d = unshard_store(store)
        return dict(values=d.values.numpy(), versions=d.versions.numpy(),
                    gv=int(d.gv))
    o = store.n_objects
    return dict(values=np.asarray(store.values).reshape(-1, store.slot)[:o],
                versions=np.asarray(store.versions).reshape(-1)[:o],
                gv=int(store.gv))


def _assert_stores_equal(a, b, msg=""):
    a, b = _dense_np(a), _dense_np(b)
    for f in ("values", "versions", "gv"):
        np.testing.assert_array_equal(a[f], b[f], err_msg=f"{msg} {f}")


def _assert_port_traces_equal(a, b, msg=""):
    a, b = convert.trace_to_numpy(a), convert.trace_to_numpy(b)
    for f in TRACE_FIELDS:
        np.testing.assert_array_equal(a[f], b[f], err_msg=f"{msg} {f}")


@pytest.fixture(params=["scatter", "matrix"])
def formulation(request, monkeypatch):
    """The dense side's formulation: the CPU's scatter-min, or the card's
    matrix formulation through the kernels' plain versions."""
    if request.param == "matrix":
        monkeypatch.setattr(ops, "_on_cuda", lambda t: True)
    return request.param


# ------------------------------------------------------------ store layout
@pytest.mark.parametrize("shards", [2, 3, 7, 8])
def test_shard_round_trip(shards):
    init = np.arange(200).reshape(100, 2)
    store = make_store(100, slot=2, init=init, device="cpu")
    sh = shard_store(store, shards)
    assert isinstance(sh, ShardedStore) and sh.shards == shards
    assert sh.shard_size == -(-100 // shards)
    back = unshard_store(sh)
    for f in ("values", "versions"):
        assert torch.equal(getattr(back, f), getattr(store, f))
    assert fingerprint(sh) == fingerprint(store) \
        == int(ref_fingerprint(ref_shard_store(
            ref_make_store(100, slot=2, init=init), shards)))
    assert torch.equal(torch.cat([v for v, _ in shard_images(sh)]),
                       store.values)


def test_one_shard_stays_dense():
    store = make_store(32, device="cpu")
    assert shard_store(store, 1) is store
    assert unshard_store(store) is store
    assert isinstance(make_store(32, shards=1, device="cpu"), TStore)
    assert shard_images(store)[0][0] is store.values
    wl = _wl(W, 8, "med", 4, device="cpu")
    out_a, tr_a = _run("pcc", make_store(wl.n_objects, device="cpu"), wl)
    out_b, tr_b = _run("pcc", shard_store(
        make_store(wl.n_objects, device="cpu"), 1), wl)
    _assert_stores_equal(out_a, out_b)
    _assert_port_traces_equal(tr_a, tr_b)


def test_make_store_sharded():
    sh = make_store(64, shards=4, device="cpu")
    assert isinstance(sh, ShardedStore)
    assert sh.values.shape == (4, 16, 1) and sh.versions.shape == (4, 16)
    assert sh.layout == StoreLayout(64, 4) and sh.device.type == "cpu"


def test_flat_values_is_a_view_of_the_shards():
    """Execution reads the shards through the flat image; a write into it
    must be a write into the shards (never a copy a write-back misses)."""
    store = make_store(10, init=np.arange(10), device="cpu")
    sh = shard_store(store, 4)     # C = 3, padded to 12
    flat = flat_values(sh.values, sh.layout)
    assert flat.shape == (12, 1)
    assert torch.equal(flat[:10], store.values)
    flat[7, 0] = -1
    assert int(sh.values[2, 1, 0]) == -1
    assert flat_values(store.values, store.layout) is store.values


@pytest.mark.parametrize("n_objects,shards", [(10, 4), (100, 7), (101, 8),
                                              (80, 3)])
def test_layout_address_map_matches_reference(n_objects, shards):
    lay, ref = StoreLayout(n_objects, shards), RefLayout(n_objects, shards)
    for attr in ("shard_size", "padded_objects", "sharded",
                 "words_per_shard"):
        assert getattr(lay, attr) == getattr(ref, attr), attr
    addrs = torch.arange(n_objects)
    np.testing.assert_array_equal(
        lay.shard_of(addrs).numpy(),
        np.asarray(ref.shard_of(jnp.arange(n_objects))))
    assert torch.equal(lay.shard_of(addrs) * lay.shard_size
                       + lay.offset_of(addrs), addrs)


@pytest.mark.parametrize("n_objects", [101, 80])
@pytest.mark.parametrize("shards", [3, 8])
def test_padding_is_left_out_of_the_fingerprint(n_objects, shards):
    """The last shard's padding rows are never part of the image: with
    garbage written into them the fingerprint is still the reference's
    dense one."""
    init = np.random.default_rng(n_objects).integers(
        -(1 << 31), (1 << 31) - 1, (n_objects, 1)).astype(np.int32)
    sh = shard_store(make_store(n_objects, init=init, device="cpu"), shards)
    pad = sh.layout.padded_objects - n_objects
    flat_values(sh.values, sh.layout)[n_objects:] = 12345
    assert dense_image(sh).shape == (n_objects, 1)
    assert fingerprint(sh) == int(ref_fingerprint(
        ref_make_store(n_objects, init=init)))
    assert sum(v.shape[0] for v, _ in shard_images(sh)) == n_objects
    assert pad == RefLayout(n_objects, shards).padded_objects - n_objects


def test_store_and_shards_together_raise_and_mesh_is_not_ported():
    store = make_store(16, device="cpu")
    with pytest.raises(ValueError, match="not both"):
        PotSession(store=shard_store(store, 2), shards=4, device="cpu")
    # a mesh is one shard per rank (tests/test_torch_store_mesh.py); one
    # that is not a 1-D mesh of ``shards`` ranks is refused
    with pytest.raises(ValueError, match="exactly one axis"):
        PotSession(16, shards=2, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="exactly one axis"):
        make_store(16, shards=2, mesh=object(), device="cpu")
    s = PotSession(store=shard_store(store, 2), device="cpu")
    assert s.store.layout == StoreLayout(16, 2)
    assert PotSession(store=store, shards=4, device="cpu").store.shards == 4


# --------------------------------------------- per-shard conflict analysis
def _both_results(k, seed, n_objects, values_seed):
    """One batch run against one random image, as a port result and the
    same numbers as a reference result (the executors' parity is
    test_torch_txn.py's)."""
    wl = W.counters(n_txns=k, n_objects=n_objects, n_reads=2, n_writes=2,
                    n_lanes=4, skew=1.0, seed=seed, device="cpu")
    values = np.random.default_rng(values_seed).integers(
        0, 100, (n_objects, 1)).astype(np.int32)
    res = run_all(wl.batch, torch.from_numpy(values))
    return res, ref_result(res)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("shards", [2, 3, 8])
def test_or_reduced_table_matches_reference_and_dense(shards):
    res, rres = _both_results(32, 11, 40, 0)
    layout, rlayout = StoreLayout(40, shards), RefLayout(40, shards)
    foot, write = ops.packed_footprints_sharded(
        res.raddrs, res.rn, res.waddrs, res.wn, layout)
    rfoot, rwrite = ref_ops.packed_footprints_sharded(
        rres.raddrs, rres.rn, rres.waddrs, rres.wn, rlayout)
    assert foot.shape == (shards, 32, layout.words_per_shard)
    np.testing.assert_array_equal(foot.numpy(), _np(rfoot))
    np.testing.assert_array_equal(write.numpy(), _np(rwrite))
    got = ops.conflict_matrix_sharded(foot, write)
    np.testing.assert_array_equal(
        got.numpy(), _np(ref_ops.conflict_matrix_sharded(rfoot, rwrite)))
    np.testing.assert_array_equal(got.numpy(), ops._conflict_matrix_dense(
        res.raddrs, res.rn, res.waddrs, res.wn, 40).numpy())


@pytest.mark.parametrize("shards", [2, 8])
def test_delta_matches_reference_over_rounds(shards):
    """Shrinking live sets over changing images: the OR of the S delta
    launches against ``old`` equals the reference's table and, on the
    refreshed entries, a from-scratch table."""
    layout, rlayout = StoreLayout(40, shards), RefLayout(40, shards)
    res, rres = _both_results(24, 3, 40, 0)
    foot, write = ops.packed_footprints_sharded(
        res.raddrs, res.rn, res.waddrs, res.wn, layout)
    rfoot, rwrite = ref_ops.packed_footprints_sharded(
        rres.raddrs, rres.rn, rres.waddrs, rres.wn, rlayout)
    table = ops.conflict_matrix_sharded(foot, write)
    rtable = ref_ops.conflict_matrix_sharded(rfoot, rwrite)
    rng = np.random.default_rng(5)
    for i, n_live in enumerate((12, 5, 1, 0)):
        live = np.zeros(24, bool)
        live[rng.choice(24, n_live, replace=False)] = True
        res, rres = _both_results(24, 3, 40, i + 1)
        foot, write = ops.update_packed_footprints_sharded(
            foot, write, res.raddrs, res.rn, res.waddrs, res.wn,
            torch.from_numpy(live), layout)
        table = ops.conflict_matrix_delta_sharded(
            foot, write, table, torch.from_numpy(live))
        rfoot, rwrite = ref_ops.update_packed_footprints_sharded(
            rfoot, rwrite, rres.raddrs, rres.rn, rres.waddrs, rres.wn,
            jnp.asarray(live), rlayout)
        rtable = ref_ops.conflict_matrix_delta_sharded(
            rfoot, rwrite, rtable, jnp.asarray(live), rlayout)
        np.testing.assert_array_equal(foot.numpy(), _np(rfoot))
        np.testing.assert_array_equal(table.numpy(), _np(rtable))
        fresh = ops._conflict_matrix_dense(res.raddrs, res.rn, res.waddrs,
                                           res.wn, 40).numpy()
        refresh = live[:, None] | live[None, :]
        np.testing.assert_array_equal(table.numpy()[refresh],
                                      fresh[refresh])


@pytest.mark.parametrize("shards", [2, 8])
def test_compact_strips_match_masked_delta_and_reference(shards):
    layout, rlayout = StoreLayout(40, shards), RefLayout(40, shards)
    res0, rres0 = _both_results(24, 9, 40, 0)
    foot, write = ops.packed_footprints_sharded(
        res0.raddrs, res0.rn, res0.waddrs, res0.wn, layout)
    rfoot, rwrite = ref_ops.packed_footprints_sharded(
        rres0.raddrs, rres0.rn, rres0.waddrs, rres0.wn, rlayout)
    table = ops.conflict_matrix_sharded(foot, write)
    live = np.zeros(24, bool)
    live[np.random.default_rng(13).choice(24, 6, replace=False)] = True
    res, rres = _both_results(24, 9, 40, 1)
    idx, valid = gather_live_indices(torch.from_numpy(live), 8)
    ridx, rvalid = ref_gather(jnp.asarray(live), 8)
    np.testing.assert_array_equal(idx.numpy(), _np(ridx))
    cres = res.map(lambda a: a[idx])
    cfoot, cwrite = ops.update_packed_footprints_compact_sharded(
        foot, write, cres.raddrs, torch.where(valid, cres.rn, 0),
        cres.waddrs, torch.where(valid, cres.wn, 0), idx, valid, layout)
    got = ops.conflict_matrix_delta_compact_sharded(
        cfoot, cwrite, table, idx, valid)
    mfoot, mwrite = ops.update_packed_footprints_sharded(
        foot, write, res.raddrs, res.rn, res.waddrs, res.wn,
        torch.from_numpy(live), layout)
    exp = ops.conflict_matrix_delta_sharded(mfoot, mwrite, table,
                                            torch.from_numpy(live))
    assert torch.equal(cfoot, mfoot) and torch.equal(cwrite, mwrite)
    assert torch.equal(got, exp)
    rc = {f: _np(getattr(rres, f))[_np(ridx)] for f in
          ("raddrs", "rn", "waddrs", "wn")}
    rcfoot, rcwrite = ref_ops.update_packed_footprints_compact_sharded(
        rfoot, rwrite, jnp.asarray(rc["raddrs"]),
        jnp.where(rvalid, rc["rn"], 0), jnp.asarray(rc["waddrs"]),
        jnp.where(rvalid, rc["wn"], 0), ridx, rvalid, rlayout)
    rgot = ref_ops.conflict_matrix_delta_compact_sharded(
        rcfoot, rcwrite, ref_ops.conflict_matrix_sharded(rfoot, rwrite),
        ridx, rvalid, rlayout)
    np.testing.assert_array_equal(cfoot.numpy(), _np(rcfoot))
    np.testing.assert_array_equal(got.numpy(), _np(rgot))


@pytest.mark.parametrize("n_objects,shards", [(70, 2), (96, 8), (1000, 3)])
def test_spec_read_invalid_sharded_matches_reference(n_objects, shards):
    """The cross-batch validation per shard: dirty words (S, W_s) and
    the OR-reduced verdicts equal the reference's and the dense ones."""
    rng = np.random.default_rng(n_objects)
    versions = rng.integers(0, 12, (n_objects,)).astype(np.int32)
    versions[31::32] = 99
    res, rres = _both_results(24, 2, n_objects, 0)
    layout, rlayout = StoreLayout(n_objects, shards), \
        RefLayout(n_objects, shards)
    sh = shard_store(make_store(n_objects, device="cpu"), shards)
    flat = sh.versions.view(-1)
    flat[:n_objects] = torch.from_numpy(versions)
    rsh = ref_shard_store(ref_make_store(n_objects), shards)
    rvers = jnp.asarray(sh.versions.numpy())
    snap = np.int32(10)
    words = ops.spec_dirty_words_sharded(sh.versions, snap, layout)
    np.testing.assert_array_equal(words.numpy(), _np(
        ref_ops.spec_dirty_words_sharded(rvers, snap, rlayout)))
    got = ops.spec_read_invalid_sharded(res.raddrs, res.rn, sh.versions,
                                        snap, layout)
    np.testing.assert_array_equal(got.numpy(), _np(
        ref_ops.spec_read_invalid_sharded(rres.raddrs, rres.rn, rvers,
                                          snap, rlayout)))
    assert torch.equal(got, ops.spec_read_invalid(
        res.raddrs, res.rn, torch.from_numpy(versions), snap, n_objects))
    assert rsh.versions.shape == sh.versions.shape


def test_sharded_ops_take_the_kernels_wrappers(monkeypatch):
    """Each sharded twin calls its kernel wrapper once per shard (the
    kernel on the card, its plain version here): pair for the table and
    the strips, delta for the full rung, validate for the cross-batch
    strip."""
    calls = {"pair": 0, "delta": 0, "validate": 0}
    for key, mod, name in (("pair", conflict, "conflict_matrix_bits_pair"),
                           ("delta", conflict, "conflict_matrix_bits_delta"),
                           ("validate", validate, "validate_bitsets")):
        def counted(*args, _fn=getattr(mod, name), _key=key):
            calls[_key] += 1
            return _fn(*args)
        monkeypatch.setattr(mod, name, counted)
    shards = 4
    layout = StoreLayout(40, shards)
    res, _ = _both_results(16, 1, 40, 0)
    foot, write = ops.packed_footprints_sharded(
        res.raddrs, res.rn, res.waddrs, res.wn, layout)
    live = torch.ones(16, dtype=torch.bool)
    ops.conflict_matrix_delta_sharded(foot, write,
                                      torch.zeros(16, 16, dtype=torch.bool),
                                      live)
    idx, valid = gather_live_indices(live, 16)
    ops.conflict_matrix_delta_compact_sharded(
        foot, write, torch.zeros(16, 16, dtype=torch.bool), idx, valid)
    ops.spec_read_invalid_sharded(res.raddrs, res.rn,
                                  torch.zeros(shards, 10, dtype=torch.int32),
                                  0, layout)
    assert calls == {"pair": 2 * shards, "delta": shards,
                     "validate": shards}


# -------------------------------------------------- write-back primitives
@pytest.mark.parametrize("shards", [2, 3, 8])
def test_fused_write_back_matches_dense(shards):
    k, length, n_obj, slot = 16, 5, 37, 2
    rng = np.random.default_rng(shards)
    waddrs = torch.from_numpy(rng.integers(0, n_obj, (k, length)).astype(
        np.int32))
    wvals = torch.from_numpy(rng.integers(0, 99, (k, length, slot)).astype(
        np.int32))
    wn = torch.from_numpy(rng.integers(0, length + 1, (k,)).astype(np.int32))
    committing = torch.from_numpy(rng.random(k) < 0.6)
    rank = torch.from_numpy(rng.permutation(k).astype(np.int32))
    dense = make_store(n_obj, slot=slot, device="cpu")
    sh = shard_store(dense, shards)
    dv, dver = protocol.fused_write_back(
        dense.values.clone(), dense.versions.clone(), waddrs, wvals, wn,
        committing, rank, rank + 5)
    sv, sver = protocol.fused_write_back(
        sh.values.clone(), sh.versions.clone(), waddrs, wvals, wn,
        committing, rank, rank + 5, sh.layout)
    assert torch.equal(dv, sv.reshape(-1, slot)[:n_obj])
    assert torch.equal(dver, sver.reshape(-1)[:n_obj])
    assert not sver.reshape(-1)[n_obj:].any()     # padding untouched
    assert not sh.values.any()                    # written in place: copies


@pytest.mark.parametrize("shards", [2, 8])
def test_apply_writes_matches_dense(shards):
    length, n_obj = 6, 21
    rng = np.random.default_rng(41 + shards)
    for _ in range(5):
        waddrs = torch.from_numpy(rng.integers(0, n_obj, (length,)).astype(
            np.int32))
        wvals = torch.from_numpy(rng.integers(0, 99, (length, 1)).astype(
            np.int32))
        wn = int(rng.integers(0, length + 1))
        dense = make_store(n_obj, device="cpu")
        sh = shard_store(make_store(n_obj, device="cpu"), shards)
        protocol.apply_writes(dense.values, dense.versions, waddrs, wvals,
                              wn, 7)
        protocol.apply_writes(sh.values, sh.versions, waddrs, wvals, wn, 7,
                              sh.layout)
        _assert_stores_equal(dense, sh)


# ------------------------------------------------------- engine equality
@pytest.mark.parametrize("shards", [2, 8])
@pytest.mark.parametrize("engine", ENGINES)
def test_engine_sharded_equals_reference_and_dense(engine, shards,
                                                   formulation):
    """Each engine at S shards: bitwise the reference's sharded run and
    the port's dense run, in the store and every trace field."""
    wl = _wl(W, 24, "med", 7, device="cpu")
    rwl = _wl(ref_W, 24, "med", 7)
    out_d, tr_d = _run(engine, make_store(wl.n_objects, device="cpu"), wl)
    out_s, tr_s = _run(engine, shard_store(
        make_store(wl.n_objects, device="cpu"), shards), wl)
    assert isinstance(out_s, ShardedStore) and out_s.shards == shards
    msg = f"{engine} S={shards}"
    _assert_stores_equal(out_s, out_d, msg)
    _assert_port_traces_equal(tr_s, tr_d, msg)
    ref_out, ref_tr = _ref_run(engine, ref_shard_store(
        ref_make_store(wl.n_objects), shards), rwl)
    _assert_stores_equal(out_s, ref_out, msg)
    assert_traces_equal([tr_s], [ref_tr], msg)
    assert fingerprint(out_s) == int(ref_fingerprint(ref_out))


@pytest.mark.parametrize("k", [1, 2, 64])
@pytest.mark.parametrize("contention", ["low", "med"])
@pytest.mark.parametrize("engine", ENGINES)
def test_engine_sharded_equals_dense(engine, contention, k):
    wl = _wl(W, k, contention, 13 * k, device="cpu")
    out_d, tr_d = _run(engine, make_store(wl.n_objects, device="cpu"), wl)
    for shards in (2, 8):
        out_s, tr_s = _run(engine, shard_store(
            make_store(wl.n_objects, device="cpu"), shards), wl)
        msg = f"{engine} K={k} {contention} S={shards}"
        _assert_stores_equal(out_s, out_d, msg)
        _assert_port_traces_equal(tr_s, tr_d, msg)


@pytest.mark.parametrize("engine", ["pcc", "occ", "destm"])
def test_engine_sharded_masked_path(engine):
    """compact=False and incremental=False stay shard-invariant too."""
    wl = _wl(W, 32, "med", 2, device="cpu")
    for kw in (dict(compact=False), dict(incremental=False)):
        out_d, tr_d = _run(engine, make_store(wl.n_objects, device="cpu"),
                           wl, **kw)
        out_s, tr_s = _run(engine, shard_store(
            make_store(wl.n_objects, device="cpu"), 4), wl, **kw)
        _assert_stores_equal(out_s, out_d, f"{engine} {kw}")
        _assert_port_traces_equal(tr_s, tr_d, f"{engine} {kw}")


@settings(max_examples=15, deadline=None)
@given(k=st.integers(1, 24), shards=st.sampled_from([2, 3, 5, 8]),
       skew=st.one_of(st.just(0.0), st.floats(1e-6, 1.5)),
       seed=st.integers(0, 99))
def test_pcc_sharded_equals_dense_property(k, shards, skew, seed):
    wl = W.counters(n_txns=k, n_objects=max(8, 2 * k), n_reads=2,
                    n_writes=2, n_lanes=min(4, k), skew=skew, seed=seed,
                    device="cpu")
    dense = make_store(wl.n_objects, device="cpu")
    out_d, tr_d = _run("pcc", dense, wl)
    out_s, tr_s = _run("pcc", shard_store(dense, shards), wl)
    _assert_stores_equal(out_s, out_d)
    _assert_port_traces_equal(tr_s, tr_d)


# --------------------------------------------------------------- session
def _stream(seed=17, n=8, n_objects=101):
    rng = np.random.default_rng(seed)
    batches, lanes = [], []
    for i in range(n):
        kk = int(rng.integers(1, 33))
        wl = W.counters(n_txns=kk, n_objects=n_objects, n_reads=2,
                        n_writes=2, n_lanes=min(N_LANES, kk), skew=0.8,
                        seed=200 + i, device="cpu")
        batches.append(wl.batch)
        lanes.append(wl.lanes.tolist())
    return batches, lanes


@pytest.mark.parametrize("engine", ENGINES)
def test_session_sharded_stream_bitwise(engine):
    batches, lanes = _stream()
    ref = PotSession(101, engine=engine, n_lanes=N_LANES, device="cpu")
    ref_traces = ref.run_stream(batches, lanes)
    for shards in (2, 8):
        s = PotSession(101, engine=engine, n_lanes=N_LANES, shards=shards,
                       device="cpu")
        traces = s.run_stream(batches, lanes)
        assert isinstance(s.store, ShardedStore)
        assert s.fingerprint() == ref.fingerprint(), (engine, shards)
        assert s.replay_log() == ref.replay_log(), (engine, shards)
        assert s.gv == ref.gv
        for a, b in zip(traces, ref_traces):
            _assert_port_traces_equal(a, b, f"{engine} S={shards}")


def test_session_sharded_replay_round_trip():
    wl = W.counters(n_txns=24, n_objects=64, n_lanes=4, skew=0.9, seed=31,
                    device="cpu")
    rec = PotSession(64, engine="occ", n_lanes=4, shards=4, device="cpu")
    rec.submit(wl.batch, wl.lanes.tolist())
    replay = PotSession(64, engine="occ", n_lanes=4, shards=4,
                        sequencer=rec.replay_sequencer(), device="cpu")
    replay.submit(wl.batch, wl.lanes.tolist())
    assert replay.fingerprint() == rec.fingerprint()
    assert replay.replay_log() == rec.replay_log()


@pytest.mark.parametrize("engine", ENGINES)
def test_session_sharded_pipelined_equals_serial(engine, monkeypatch):
    """Depth 2 on a sharded store: the speculation's seeds carry
    (S, K, W_s) words and the cross-batch strip runs per shard; the
    stream equals the dense serial stream in every field but ``spec_*``,
    and every real row is speculated."""
    calls = {"validate": 0}

    def counted(*args, _fn=validate.validate_bitsets):
        calls["validate"] += 1
        return _fn(*args)

    monkeypatch.setattr(validate, "validate_bitsets", counted)
    batches, lanes = _stream(seed=5, n=5)
    serial = PotSession(101, engine=engine, n_lanes=N_LANES, device="cpu")
    t0 = serial.run_stream(batches, lanes)
    s = PotSession(101, engine=engine, n_lanes=N_LANES, shards=8,
                   pipeline_depth=2, device="cpu")
    t1 = s.run_stream(batches, lanes)
    assert s.fingerprint() == serial.fingerprint()
    assert s.replay_log() == serial.replay_log()
    for i, (a, b) in enumerate(zip(t0, t1)):
        a, b = convert.trace_to_numpy(a), convert.trace_to_numpy(b)
        for f in TRACE_FIELDS:
            if not f.startswith("spec_"):
                np.testing.assert_array_equal(a[f], b[f],
                                              err_msg=f"{engine} {i} {f}")
    assert sum(int(t.spec_executed) for t in t1) == \
        sum(b.n_txns for b in batches)
    assert calls["validate"] > 0
