"""Parity of the port's round protocol with the JAX reference, piece by
piece: ranks, last-writer dedup, the two formulations of the conflict
question, the prefix decision, the fused write-back, and the round
state's refresh at the full and compact rungs, in both formulations
(scatter-min on CPU tensors; packed bitsets and a carried table with
``_on_cuda`` patched, as the card takes them)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from _torch_parity import (assert_results_equal, port_batch, port_result,
                           random_batch, random_values, ref_batch)

from repro.core import engine as ref_engine
from repro.core import protocol as ref_protocol
from repro.core import txn as ref_txn
from repro_torch.core import engine, protocol
from repro_torch.kernels import ops

# the shapes of tests/test_round_state.py
K, L, N_OBJ = 64, 8, 48


def _res(seed):
    """A reference TxnResult from a random batch, and its port twin."""
    rng = np.random.default_rng(seed)
    arrays = random_batch(rng, K, L, N_OBJ)
    values = random_values(rng, N_OBJ, 1)
    ref = ref_txn.run_all(ref_batch(arrays), jnp.asarray(values))
    return rng, arrays, values, ref, port_result(ref)


def test_ranks_match_reference():
    seq = np.random.default_rng(0).permutation(K).astype(np.int32) + 1
    np.testing.assert_array_equal(
        engine.seq_rank(torch.from_numpy(seq)).numpy(),
        np.asarray(ref_engine.seq_rank(jnp.asarray(seq))))
    order = np.argsort(seq)
    np.testing.assert_array_equal(
        engine.rank_from_order(torch.from_numpy(order)).numpy(),
        np.asarray(ref_engine.rank_from_order(jnp.asarray(order))))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dedup_and_apply_writes_match_reference(seed):
    rng = np.random.default_rng(seed)
    waddrs = rng.integers(0, 6, (L,)).astype(np.int32)   # many repeats
    wvals = rng.integers(-9, 9, (L, 1)).astype(np.int32)
    wn = int(rng.integers(0, L + 1))
    np.testing.assert_array_equal(
        protocol.dedup_last_writer(torch.from_numpy(waddrs), wn).numpy(),
        np.asarray(ref_protocol.dedup_last_writer(jnp.asarray(waddrs), wn)))
    values = random_values(rng, N_OBJ, 1)
    versions = np.zeros(N_OBJ, np.int32)
    got = protocol.apply_writes(
        torch.from_numpy(values.copy()), torch.from_numpy(versions.copy()),
        torch.from_numpy(waddrs), torch.from_numpy(wvals), wn, 7)
    exp = ref_protocol.apply_writes(
        jnp.asarray(values), jnp.asarray(versions), jnp.asarray(waddrs),
        jnp.asarray(wvals), jnp.asarray(wn), 7)
    for g, e in zip(got, exp):
        np.testing.assert_array_equal(g.numpy(), np.asarray(e))


@pytest.mark.parametrize("seed", [3, 4])
def test_conflict_formulations_and_decisions_match_reference(
        seed, monkeypatch):
    rng, _, values, ref_res, res = _res(seed)
    seq = rng.permutation(K).astype(np.int32) + 1
    order = np.argsort(seq)
    rank = np.asarray(ref_engine.rank_from_order(jnp.asarray(order)))
    writer = rng.random(K) < 0.6
    real = rng.random(K) < 0.9
    with monkeypatch.context() as m:   # the card's matrix formulation
        m.setattr(ops, "_on_cuda", lambda t: True)
        table = protocol.conflict_table(res, N_OBJ)
    ref_table = ref_protocol.conflict_table(ref_res, N_OBJ, use_matrix=True)
    np.testing.assert_array_equal(table.numpy(), np.asarray(ref_table))
    assert protocol.conflict_table(res, N_OBJ) is None   # CPU: scatter-min

    t = lambda a: torch.from_numpy(np.array(a))
    exp_bad = np.asarray(ref_protocol.earlier_writer_conflicts(
        ref_res, None, jnp.asarray(writer), jnp.asarray(rank), N_OBJ))
    for conflict in (None, table):
        bad = protocol.earlier_writer_conflicts(res, conflict, t(writer),
                                                t(rank), N_OBJ)
        np.testing.assert_array_equal(bad.numpy(), exp_bad)

    for n_comm in (0, 5):
        exp = np.asarray(ref_protocol.prefix_commit(
            ref_res, None, jnp.asarray(order), jnp.asarray(rank),
            jnp.asarray(n_comm, jnp.int32), N_OBJ, jnp.asarray(real)))
        for conflict in (None, table):
            got = protocol.prefix_commit(res, conflict, t(order), t(rank),
                                         n_comm, N_OBJ, t(real))
            np.testing.assert_array_equal(got.numpy(), exp)

    committing = rng.random(K) < 0.5
    got = protocol.fused_write_back(
        t(values.copy()), t(np.zeros(N_OBJ, np.int32)), res.waddrs,
        res.wvals, res.wn, t(committing), t(rank), t(rank + 11))
    exp = ref_protocol.fused_write_back(
        jnp.asarray(values), jnp.zeros(N_OBJ, jnp.int32), ref_res.waddrs,
        ref_res.wvals, ref_res.wn, jnp.asarray(committing),
        jnp.asarray(rank), jnp.asarray(rank + 11))
    for g, e in zip(got, exp):
        np.testing.assert_array_equal(g.numpy(), np.asarray(e))


@pytest.mark.parametrize("packed", [False, True],
                         ids=["scatter-min", "packed-bitsets"])
def test_round_state_refresh_matches_reference(packed, monkeypatch):
    """Three shrinking rounds — full rung, then two compact ones — on the
    CPU's scatter-min formulation (no table) or, with ``_on_cuda``
    patched, on packed bitsets and a carried table refreshed by the
    kernels' plain versions.  The reference carries its dense table
    (use_matrix); both formulations must reach its verdicts."""
    if packed:
        monkeypatch.setattr(ops, "_on_cuda", lambda t: True)
    rng = np.random.default_rng(9)
    arrays = random_batch(rng, K, L, N_OBJ)
    values = random_values(rng, N_OBJ, 1)
    versions = np.zeros(N_OBJ, np.int32)
    rs = protocol.init_round_state(port_batch(arrays),
                                   torch.from_numpy(values),
                                   torch.from_numpy(versions))
    assert (rs.foot_bits is not None) == packed
    assert (rs.conflict is not None) == packed
    ref_rs = ref_protocol.init_round_state(
        ref_batch(arrays), jnp.asarray(values), jnp.asarray(versions),
        use_matrix=True)
    rank = np.random.default_rng(10).permutation(K).astype(np.int32)
    live = np.ones(K, bool)
    for rnd, width in enumerate((K, 16, 16)):
        if rnd:
            live = live & (rng.random(K) < 0.3)
            live[np.flatnonzero(live)[16:]] = False
            new_values = random_values(rng, N_OBJ, 1)
            rs = protocol.commit_round_state(
                rs, torch.from_numpy(new_values), rs.versions)
            ref_rs = ref_protocol.commit_round_state(
                ref_rs, jnp.asarray(new_values), ref_rs.versions)
        if width == K:
            rs = protocol.refresh_round_state(rs, port_batch(arrays),
                                              torch.from_numpy(live))
            ref_rs = ref_protocol.refresh_round_state(
                ref_rs, ref_batch(arrays), jnp.asarray(live))
        else:
            rs = protocol.refresh_round_state_compact(
                rs, port_batch(arrays), torch.from_numpy(live), width)[0]
            ref_rs = ref_protocol.refresh_round_state_compact(
                ref_rs, ref_batch(arrays), jnp.asarray(live), width)[0]
        assert_results_equal(rs.res, ref_rs.res, f"round {rnd}")
        if packed:
            np.testing.assert_array_equal(rs.conflict.numpy(),
                                          np.asarray(ref_rs.conflict))
        # every transaction pending: the verdicts over all rows
        bad = protocol.earlier_writer_conflicts(
            rs.res, rs.conflict, torch.ones(K, dtype=torch.bool),
            torch.from_numpy(rank), N_OBJ)
        exp_bad = ref_protocol.earlier_writer_conflicts(
            ref_rs.res, ref_rs.conflict, jnp.ones(K, bool),
            jnp.asarray(rank), N_OBJ)
        np.testing.assert_array_equal(bad.numpy(), np.asarray(exp_bad),
                                      err_msg=f"round {rnd}")
        for f in ("live", "live_txns", "live_slots", "walked_slots"):
            np.testing.assert_array_equal(getattr(rs, f).numpy(),
                                          np.asarray(getattr(ref_rs, f)))
