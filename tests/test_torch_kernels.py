"""Parity of the port's conflict-table kernels (their plain versions, as
the CPU runs them) with the JAX reference: ``kernels.ref`` and the
Pallas kernels run with ``interpret=True``, as tests/test_kernels.py
runs them, plus the ``ops`` table updates of both packages.  Every
comparison is bitwise."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.core.txn import gather_live_indices as ref_gather
from repro.kernels import conflict as ref_conf
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro_torch.core.txn import gather_live_indices
from repro_torch.kernels import conflict, ops

# the reference kernels' tile: rows multiple of 128, words of 128
BLK, BW = max(ref_conf.BI, ref_conf.BJ), ref_conf.BW


def _bits(rng, rows, w, density):
    """Sparse random words over the full int32 range (bit 31 included)."""
    words = rng.integers(-(1 << 31), 1 << 31, (rows, w), dtype=np.int64)
    return np.where(rng.random((rows, w)) < density, words, 0).astype(
        np.int32)


@pytest.mark.parametrize("m,n,w", [(1, 1, 1), (13, 40, 7), (70, 65, 33)])
def test_pair_plain_matches_bits_ref(m, n, w):
    rng = np.random.default_rng(m * 7 + n)
    foot, write = _bits(rng, m, w, 0.1), _bits(rng, n, w, 0.05)
    got = conflict.conflict_matrix_bits_pair(torch.from_numpy(foot),
                                             torch.from_numpy(write))
    exp = ((foot[:, None, :] & write[None, :, :]) != 0).any(axis=2)
    np.testing.assert_array_equal(got.numpy(), exp)
    if m == n:
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(ref_ref.conflict_matrix_bits_ref(
                jnp.asarray(foot), jnp.asarray(write))))


def test_square_plain_matches_bits_ref():
    rng = np.random.default_rng(3)
    foot, write = _bits(rng, 40, 9, 0.1), _bits(rng, 40, 9, 0.05)
    got = conflict.conflict_matrix_bits(torch.from_numpy(foot),
                                        torch.from_numpy(write))
    exp = ref_ref.conflict_matrix_bits_ref(jnp.asarray(foot),
                                           jnp.asarray(write))
    np.testing.assert_array_equal(got.numpy(), np.asarray(exp))


@pytest.mark.parametrize("m,w", [(ref_conf.BI, BW), (2 * ref_conf.BI,
                                                     2 * BW)])
def test_pair_plain_matches_pallas_interpret(m, w):
    rng = np.random.default_rng(m + w)
    foot, write = _bits(rng, m, w, 0.2), _bits(rng, BLK, w, 0.05)
    got = conflict.conflict_matrix_bits_pair(torch.from_numpy(foot),
                                             torch.from_numpy(write))
    exp = ref_conf.conflict_matrix_bits_pair(
        jnp.asarray(foot), jnp.asarray(write), interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(exp))
    assert got.any() and not got.all()


@pytest.mark.parametrize("live_frac", [0.0, 0.3, 1.0])
def test_delta_plain_matches_pallas_interpret(live_frac):
    rng = np.random.default_rng(int(live_frac * 10) + 1)
    w = 2 * BW   # two word blocks: the Pallas kernel OR-accumulates
    foot, write = _bits(rng, BLK, w, 0.2), _bits(rng, BLK, w, 0.05)
    old = rng.random((BLK, BLK)) < 0.5
    live = rng.random(BLK) < live_frac
    got = conflict.conflict_matrix_bits_delta(
        torch.from_numpy(foot), torch.from_numpy(write),
        torch.from_numpy(old), torch.from_numpy(live))
    exp = ref_conf.conflict_matrix_bits_delta(
        jnp.asarray(foot), jnp.asarray(write),
        jnp.asarray(old.astype(np.int32)), jnp.asarray(live, jnp.int32),
        interpret=True)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), np.asarray(exp) != 0)


def _footprints(rng, k, length, n_objects):
    mk = lambda: (rng.integers(0, n_objects, (k, length)).astype(np.int32),
                  rng.integers(0, length + 1, (k,)).astype(np.int32))
    (ra, rn), (wa, wn) = mk(), mk()
    return ra, rn, wa, wn


def _packed(arrays, n_objects):
    ra, rn, wa, wn = (torch.from_numpy(a) for a in arrays)
    return ops.packed_footprints(ra, rn, wa, wn, n_objects)


@pytest.mark.parametrize("k,length,n_objects", [(1, 1, 32), (20, 6, 300),
                                                (33, 3, 4096)])
def test_conflict_matrix_matches_reference(k, length, n_objects):
    arrays = _footprints(np.random.default_rng(k), k, length, n_objects)
    got = ops.conflict_matrix(*(torch.from_numpy(a) for a in arrays),
                              n_objects)
    exp = ref_ops.conflict_matrix(*(jnp.asarray(a) for a in arrays),
                                  n_objects)
    np.testing.assert_array_equal(got.numpy(), np.asarray(exp))
    # the packed formulation the card takes gives the same table
    np.testing.assert_array_equal(
        conflict.conflict_matrix_bits(*_packed(arrays, n_objects)).numpy(),
        np.asarray(exp))


def test_packed_footprints_match_reference():
    arrays = _footprints(np.random.default_rng(5), 24, 5, 1000)
    got = _packed(arrays, 1000)
    exp = ref_ops.packed_footprints(*(jnp.asarray(a) for a in arrays), 1000)
    for g, e in zip(got, exp):
        np.testing.assert_array_equal(g.numpy(), np.asarray(e))


@pytest.mark.parametrize("seed", [0, 1])
def test_conflict_matrix_delta_matches_reference(seed):
    rng = np.random.default_rng(seed)
    k, length, n_objects = 24, 4, 300
    old_arr = _footprints(rng, k, length, n_objects)
    new_arr = _footprints(rng, k, length, n_objects)
    live = rng.random(k) < 0.4
    old = ref_ops.conflict_matrix(*(jnp.asarray(a) for a in old_arr),
                                  n_objects)
    fb, wb = ref_ops.packed_footprints(*(jnp.asarray(a) for a in old_arr),
                                       n_objects)
    fb, wb = ref_ops.update_packed_footprints(
        fb, wb, *(jnp.asarray(a) for a in new_arr), jnp.asarray(live),
        n_objects)
    exp = ref_ops.conflict_matrix_delta(fb, wb, old, jnp.asarray(live),
                                        n_objects)

    pfb, pwb = _packed(old_arr, n_objects)
    pfb, pwb = ops.update_packed_footprints(
        pfb, pwb, *(torch.from_numpy(a) for a in new_arr),
        torch.from_numpy(live), n_objects)
    np.testing.assert_array_equal(pfb.numpy(), np.asarray(fb))
    np.testing.assert_array_equal(pwb.numpy(), np.asarray(wb))
    got = ops.conflict_matrix_delta(pfb, pwb, torch.from_numpy(
        np.array(old)), torch.from_numpy(live))
    np.testing.assert_array_equal(got.numpy(), np.asarray(exp))


@pytest.mark.parametrize("n_live", [0, 3, 8])
def test_conflict_matrix_delta_compact_matches_reference(n_live):
    rng = np.random.default_rng(40 + n_live)
    k, length, n_objects, width = 19, 4, 80, 8
    old_arr = _footprints(rng, k, length, n_objects)
    live = np.zeros(k, bool)
    live[rng.choice(k, n_live, replace=False)] = True
    new_arr = _footprints(rng, width, length, n_objects)
    idx, valid = ref_gather(jnp.asarray(live), width)

    old = ref_ops.conflict_matrix(*(jnp.asarray(a) for a in old_arr),
                                  n_objects)
    fb, wb = ref_ops.packed_footprints(*(jnp.asarray(a) for a in old_arr),
                                       n_objects)
    fb, wb = ref_ops.update_packed_footprints_compact(
        fb, wb, *(jnp.asarray(a) for a in new_arr), idx, valid, n_objects)
    exp = ref_ops.conflict_matrix_delta_compact(fb, wb, old, idx, valid,
                                                n_objects)

    pidx, pvalid = gather_live_indices(torch.from_numpy(live), width)
    np.testing.assert_array_equal(pidx.numpy(), np.asarray(idx))
    np.testing.assert_array_equal(pvalid.numpy(), np.asarray(valid))
    pfb, pwb = _packed(old_arr, n_objects)
    pfb, pwb = ops.update_packed_footprints_compact(
        pfb, pwb, *(torch.from_numpy(a) for a in new_arr), pidx, pvalid,
        n_objects)
    np.testing.assert_array_equal(pfb.numpy(), np.asarray(fb))
    got = ops.conflict_matrix_delta_compact(
        pfb, pwb, torch.from_numpy(np.array(old)), pidx, pvalid)
    np.testing.assert_array_equal(got.numpy(), np.asarray(exp))


def test_plain_versions_are_not_counted_as_launches():
    conflict.reset_launches()
    rng = np.random.default_rng(0)
    foot = torch.from_numpy(_bits(rng, 8, 4, 0.3))
    conflict.conflict_matrix_bits_pair(foot, foot)
    conflict.conflict_matrix_bits_delta(foot, foot,
                                        torch.zeros((8, 8), dtype=bool),
                                        torch.ones(8, dtype=bool))
    assert conflict.LAUNCHES == {"conflict_matrix_bits_pair": 0,
                                 "conflict_matrix_bits_delta": 0}


def test_wrappers_refuse_what_the_kernels_do_not_take():
    foot = torch.zeros((8, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        conflict.conflict_matrix_bits_pair(foot.long(), foot)
    with pytest.raises(ValueError):
        conflict.conflict_matrix_bits_pair(foot, foot[:, :3])
    with pytest.raises(ValueError):
        conflict.conflict_matrix_bits_delta(
            foot, foot, torch.zeros((8, 8), dtype=torch.int32),
            torch.ones(8, dtype=bool))
    with pytest.raises(ValueError):
        conflict.conflict_matrix_bits_pair(foot.to("meta"), foot.to("meta"))
