"""Parity of the port's ordered paged commit (its plain version, as the
CPU runs it) with the JAX reference's ``ops.kv_cache_commit`` — the
Pallas kernel in interpret mode, as tests/test_kernels.py runs it.
Every comparison is bitwise, bf16 caches included."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro_torch.kernels import kv_commit, ops

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _bits(x) -> np.ndarray:
    """Raw bits of a float array (numpy, ml_dtypes bf16 or torch)."""
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        return x.numpy().copy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype == ml_dtypes.bfloat16 else x


def _commit_both(cache, versions, rows, page_idx, row_idx, sn, commit,
                 dtype="f32"):
    """Run the reference and the port on one set of numpy inputs; assert
    bitwise equality and return the port's (cache, versions) as numpy."""
    jdt, tdt = DTYPES[dtype]
    i32 = lambda a: np.asarray(a, np.int32)
    meta = [i32(a) for a in (page_idx, row_idx, sn, commit)]
    exp_c, exp_v = ref_ops.kv_cache_commit(
        jnp.asarray(cache, jdt), jnp.asarray(versions, jnp.int32),
        jnp.asarray(rows, jnp.float32), *map(jnp.asarray, meta))
    t_cache = torch.from_numpy(np.asarray(cache, np.float32)).to(tdt)
    t_versions = torch.from_numpy(i32(versions))
    got_c, got_v = ops.kv_cache_commit(
        t_cache, t_versions, torch.from_numpy(np.asarray(rows, np.float32)),
        *map(torch.from_numpy, meta))
    np.testing.assert_array_equal(_bits(got_c), _bits(exp_c))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(exp_v))
    # functional: the inputs are left as they were
    np.testing.assert_array_equal(t_versions.numpy(), i32(versions))
    return got_c.float().numpy(), got_v.numpy()


@pytest.mark.parametrize("p,page,h,s", [
    (4, 2, 8, 3), (8, 4, 16, 5), (16, 8, 128, 8), (2, 1, 8, 4),
])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_kv_commit_sweep_matches_pallas(p, page, h, s, dtype):
    """The reference's own sweep (tests/test_kernels.py), bitwise."""
    rng = np.random.default_rng(p * 7 + s)
    _commit_both(rng.normal(size=(p, page, h)), rng.integers(0, 3, (p,)),
                 rng.normal(size=(s, h)), rng.integers(0, p, (s,)),
                 rng.integers(0, page, (s,)), np.arange(10, 10 + s),
                 rng.integers(0, 2, (s,)), dtype)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_kv_commit_hazards_match_pallas(seed, dtype):
    """Repeated pages and (page, row) pairs, arbitrary (not ascending)
    sequence numbers, skipped slots, row ids outside the page and page
    ids past either end, all in one draw."""
    rng = np.random.default_rng(100 + seed)
    p, page, h, s = 6, 4, 16, 24
    _commit_both(rng.normal(size=(p, page, h)), rng.integers(0, 5, (p,)),
                 rng.normal(size=(s, h)) * 1e3,
                 rng.integers(-3, p + 3, (s,)), rng.integers(-6, page + 6,
                                                            (s,)),
                 rng.permutation(s) + 50, rng.random(s) < 0.7, dtype)


def test_last_writer_in_array_order_wins_not_largest_sn():
    rows = np.stack([np.full(8, 1.0), np.full(8, 2.0), np.full(8, 3.0)])
    cache, versions = _commit_both(
        np.zeros((2, 2, 8)), np.zeros(2), rows, page_idx=[1, 1, 1],
        row_idx=[0, 0, 1], sn=[9, 6, 4], commit=[1, 1, 1])
    assert cache[1, 0, 0] == 2.0 and cache[1, 1, 0] == 3.0
    assert versions.tolist() == [0, 4]


def test_skipped_slots_change_nothing():
    cache, versions = _commit_both(
        np.zeros((2, 2, 8)), [7, 7], np.ones((2, 8)), page_idx=[0, 1],
        row_idx=[0, 1], sn=[9, 10], commit=[0, 0])
    assert not cache.any() and versions.tolist() == [7, 7]


def test_row_ids_outside_the_page_land_as_dynamic_update_slice_puts_them():
    """On a 4-row page: row 9 lands on row 3, row -5 on row 0, and row -2
    counts from the end, landing on row 2."""
    rows = np.stack([np.full(8, v) for v in (9.0, -5.0, -2.0)])
    cache, versions = _commit_both(
        np.zeros((3, 4, 8)), np.zeros(3), rows, page_idx=[0, 1, 2],
        row_idx=[9, -5, -2], sn=[1, 2, 3], commit=[1, 1, 1])
    assert cache[0, 3, 0] == 9.0 and cache[1, 0, 0] == -5.0
    assert cache[2, 2, 0] == -2.0
    assert np.count_nonzero(cache[..., 0]) == 3
    assert versions.tolist() == [1, 2, 3]


def test_page_ids_past_either_end_are_dropped():
    """Page 5 of 3 and page -1 commit nothing.  For page -1 the port
    follows the Pallas kernel; ``repro.kernels.ref.kv_commit_ref`` wraps
    it to the last page instead (a reference-side discrepancy)."""
    args = (np.zeros((3, 2, 8)), np.zeros(3), np.ones((3, 8)),
            [-1, 0, 5], [0, 0, 0], [4, 5, 6], [1, 1, 1])
    cache, versions = _commit_both(*args)
    assert versions.tolist() == [5, 0, 0]
    assert cache[0].any() and not cache[1:].any()
    _, wrapped = ref_ref.kv_commit_ref(*(jnp.asarray(a) for a in (
        np.zeros((3, 2, 8), np.float32), np.zeros(3, np.int32),
        np.ones((3, 8), np.float32))), *(jnp.asarray(a, jnp.int32)
                                          for a in args[3:]))
    assert np.asarray(wrapped).tolist() == [5, 0, 4]


def test_in_place_commit_equals_functional_and_counts_no_launch():
    rng = np.random.default_rng(7)
    cache = torch.from_numpy(rng.normal(size=(5, 4, 8)).astype(np.float32))
    versions = torch.zeros(5, dtype=torch.int32)
    meta = [torch.from_numpy(a.astype(np.int32)) for a in (
        rng.integers(0, 5, 9), rng.integers(0, 4, 9), np.arange(1, 10),
        np.ones(9))]
    rows = torch.from_numpy(rng.normal(size=(9, 8)).astype(np.float32))
    kv_commit.reset_launches()
    exp_c, exp_v = kv_commit.kv_commit(cache, versions, rows, *meta)
    got_c, got_v = kv_commit.kv_commit_(cache, versions, rows, *meta)
    assert got_c is cache and got_v is versions
    assert torch.equal(got_c, exp_c) and torch.equal(got_v, exp_v)
    assert kv_commit.LAUNCHES["kv_commit"] == 0


@pytest.mark.parametrize("bad", ["cache_dtype", "rows_dtype", "meta_shape",
                                 "versions_shape"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    cache = torch.zeros((2, 2, 8))
    versions = torch.zeros(2, dtype=torch.int32)
    rows = torch.zeros((3, 8))
    meta = [torch.zeros(3, dtype=torch.int32) for _ in range(4)]
    if bad == "cache_dtype":
        cache = cache.double()
    elif bad == "rows_dtype":
        rows = rows.bfloat16()
    elif bad == "meta_shape":
        meta[2] = torch.zeros(4, dtype=torch.int32)
    else:
        versions = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError):
        kv_commit.kv_commit(cache, versions, rows, *meta)
