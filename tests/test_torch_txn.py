"""Parity of the port's bytecode VM, packing and workloads with the JAX
reference: ``run_all``, ``run_live``, ``run_live_compact``,
``pack_addr_sets{,_masked}`` and the workload generators, bitwise, on
inputs made from numpy seeds."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from _hypothesis_compat import given, settings, st
from _torch_parity import (I32_MIN, assert_results_equal, port_batch,
                           port_result, random_batch, random_values,
                           ref_batch, ref_result)

from repro.core import txn as ref_txn
from repro.core import workloads as ref_W
from repro.kernels import validate as ref_val
from repro_torch import convert
from repro_torch.core import txn
from repro_torch.core import workloads as W
from repro_torch.kernels import validate

# the shapes of tests/test_round_state.py and tests/test_compact_bucket.py
K, L, N_OBJ = 64, 8, 48


@pytest.mark.parametrize("seed,slot", [(0, 1), (1, 2), (2, 1)])
def test_run_all_matches_reference(seed, slot):
    rng = np.random.default_rng(seed)
    arrays = random_batch(rng, K, L, N_OBJ)
    values = random_values(rng, N_OBJ, slot)
    port = txn.run_all(port_batch(arrays), torch.from_numpy(values))
    ref = ref_txn.run_all(ref_batch(arrays), jnp.asarray(values))
    assert_results_equal(port, ref)
    # the random programs do reach negative, wrapped accumulators
    assert (port.wvals.numpy() < 0).any()


def test_run_all_int_min_edges():
    """``|addr + last|`` wraps to INT_MIN, whose abs stays negative before
    the floor-mod; accumulators wrap past both int32 limits."""
    values = np.zeros((N_OBJ, 1), np.int32)
    values[1] = -(2 ** 31) + 5          # -5 + value  == INT_MIN
    values[2] = 2 ** 31 - 7             # 10 + value wraps negative
    values[3] = I32_MIN
    progs = [
        [(1, 1, False, 0), (1, -5, True, 0), (2, 7, True, 3)],
        [(1, 2, False, 0), (1, 10, True, 0), (3, 3, False, -9)],
        [(1, 3, False, 0), (1, 3, False, 0), (3, -1, False, I32_MIN)],
        [(3, 4, False, 2 ** 31 - 1), (3, 4, False, 2 ** 31 - 1),
         (1, 4, True, 0)],
    ]
    port_b = txn.make_batch(progs, device="cpu")
    arrays = convert.batch_to_numpy(port_b)
    port = txn.run_all(port_b, torch.from_numpy(values))
    ref = ref_txn.run_all(ref_batch(arrays), jnp.asarray(values))
    assert_results_equal(port, ref)


@pytest.mark.parametrize("seed", [3, 4])
def test_run_live_matches_reference(seed):
    rng = np.random.default_rng(seed)
    arrays = random_batch(rng, K, L, N_OBJ)
    values = random_values(rng, N_OBJ, 1)
    live = rng.random(K) < 0.5
    cache = txn.run_all(port_batch(random_batch(rng, K, L, N_OBJ)),
                        torch.from_numpy(values))
    port = txn.run_live(port_batch(arrays), torch.from_numpy(values),
                        torch.from_numpy(live), cache)
    ref = ref_txn.run_live(ref_batch(arrays), jnp.asarray(values),
                           jnp.asarray(live), ref_result(cache))
    assert_results_equal(port, ref)


@pytest.mark.parametrize("n_live", [0, 1, 16])
def test_run_live_compact_matches_reference(n_live):
    rng = np.random.default_rng(10 + n_live)
    arrays = random_batch(rng, K, L, N_OBJ)
    values = random_values(rng, N_OBJ, 1)
    live = np.zeros(K, bool)
    live[rng.choice(K, n_live, replace=False)] = True
    ref_cache = ref_txn.run_all(
        ref_batch(random_batch(rng, K, L, N_OBJ)), jnp.asarray(values))
    port = txn.run_live_compact(port_batch(arrays), torch.from_numpy(values),
                                torch.from_numpy(live),
                                port_result(ref_cache), 16)
    ref = ref_txn.run_live_compact(ref_batch(arrays), jnp.asarray(values),
                                   jnp.asarray(live), ref_cache, 16)
    assert_results_equal(port[0], ref[0], "merged")
    assert_results_equal(port[1], ref[1], "compact block")
    np.testing.assert_array_equal(port[2].numpy(), np.asarray(ref[2]))
    np.testing.assert_array_equal(port[3].numpy(), np.asarray(ref[3]))
    # merged == masked run_live (the compact path's contract)
    masked = txn.run_live(port_batch(arrays), torch.from_numpy(values),
                          torch.from_numpy(live), port_result(ref_cache))
    assert_results_equal(port[0], ref_result(masked))


@pytest.mark.parametrize("n_objects", [32, 100, 4096])
def test_pack_addr_sets_matches_reference(n_objects):
    rng = np.random.default_rng(n_objects)
    addrs = rng.integers(0, n_objects, (K, L)).astype(np.int32)
    addrs[:, 0] = 31          # bit 31 of word 0: a negative int32 word
    n = rng.integers(0, L + 1, (K,)).astype(np.int32)
    n[0] = L
    port = validate.pack_addr_sets(torch.from_numpy(addrs),
                                   torch.from_numpy(n), n_objects)
    ref = ref_val.pack_addr_sets(jnp.asarray(addrs), jnp.asarray(n),
                                 n_objects)
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))
    assert port.dtype == torch.int32 and (port.numpy() < 0).any()

    valid = rng.random((K, L)) < 0.5
    garbage = np.where(valid, addrs, -12345).astype(np.int32)
    port_m = validate.pack_addr_sets_masked(torch.from_numpy(garbage),
                                            torch.from_numpy(valid),
                                            n_objects)
    ref_m = ref_val.pack_addr_sets_masked(jnp.asarray(garbage),
                                          jnp.asarray(valid), n_objects)
    np.testing.assert_array_equal(port_m.numpy(), np.asarray(ref_m))


def _assert_same_workload(port_wl, ref_wl):
    arrays = convert.batch_to_numpy(port_wl.batch)
    for name, a in arrays.items():
        np.testing.assert_array_equal(a, np.asarray(getattr(ref_wl.batch,
                                                            name)))
    np.testing.assert_array_equal(port_wl.lanes, ref_wl.lanes)


@pytest.mark.parametrize("gen,kw", [
    ("counters", dict(n_txns=40, n_objects=64, skew=0.8, seed=2)),
    ("vacation_like", dict(n_txns=40, n_objects=1024, seed=5)),
    ("genome_like", dict(n_txns=20, seed=1)),
    ("stmbench7_like", dict(workload="w", n_txns=20, seed=3)),
])
def test_workloads_match_reference(gen, kw):
    _assert_same_workload(getattr(W, gen)(device="cpu", **kw),
                          getattr(ref_W, gen)(**kw))


@settings(max_examples=15, deadline=None)
@given(st.one_of(st.just(0.0), st.floats(1e-6, 2.0)),
       st.integers(0, 2 ** 16))
def test_counters_skew_property(skew, seed):
    # skews in (0, 1e-6) make numpy's zipf(1 + skew) raise in both
    # packages alike; they are not drawn
    kw = dict(n_txns=8, n_objects=32, n_reads=2, n_writes=2, skew=skew,
              seed=seed)
    _assert_same_workload(W.counters(device="cpu", **kw),
                          ref_W.counters(**kw))


def test_convert_round_trips_reference_state():
    """Stores, batches and traces cross between the packages unchanged."""
    from repro.core.engine import make_trace as ref_make_trace
    from repro.core.tstore import make_store as ref_make_store
    from repro_torch.core.engine import TRACE_FIELDS

    rng = np.random.default_rng(7)
    ref_store = ref_make_store(N_OBJ, slot=2,
                               init=random_values(rng, N_OBJ, 2))
    store = convert.store_from_numpy(ref_store, device="cpu")
    for name, a in convert.store_to_numpy(store).items():
        np.testing.assert_array_equal(a, np.asarray(getattr(ref_store,
                                                            name)))
    arrays = random_batch(rng, K, L, N_OBJ)
    batch = convert.batch_from_numpy(ref_batch(arrays), device="cpu")
    for name, a in convert.batch_to_numpy(batch).items():
        np.testing.assert_array_equal(a, arrays[name])
    assert batch.indirect.dtype == torch.bool
    ref_trace = ref_make_trace(K, rounds=jnp.asarray(3, jnp.int32),
                               live_per_round=jnp.arange(5, dtype=jnp.int32))
    got = convert.trace_to_numpy(convert.trace_from_numpy(ref_trace,
                                                          device="cpu"))
    assert set(got) == set(TRACE_FIELDS)
    for name in TRACE_FIELDS:
        np.testing.assert_array_equal(got[name],
                                      np.asarray(getattr(ref_trace, name)))
