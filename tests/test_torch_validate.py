"""Parity of the port's TL2 read-set validation with the JAX reference:
the plain version of the validation kernel against
``repro.kernels.ref.validate_bitsets_ref`` and against the Pallas kernel
run with ``interpret=True`` (as tests/test_kernels.py runs it), the
entry point ``ops.validate`` against the reference's, and the sort-based
packing against the reference's packing on long rows.  Every comparison
is bitwise."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro.kernels import validate as ref_val
from repro_torch.kernels import ops, ref, validate


def _bits(rng, rows, w, density):
    """Sparse random words over the full int32 range (bit 31 included)."""
    words = rng.integers(-(1 << 31), 1 << 31, (rows, w), dtype=np.int64)
    return np.where(rng.random((rows, w)) < density, words, 0).astype(
        np.int32)


@pytest.mark.parametrize("k,w", [(1, 1), (7, 3), (13, 130), (100, 33)])
def test_plain_matches_bits_ref(k, w):
    rng = np.random.default_rng(k * 7 + w)
    read, written = _bits(rng, k, w, 0.05), _bits(rng, 1, w, 0.1)[0]
    got = validate.validate_bitsets(torch.from_numpy(read),
                                    torch.from_numpy(written))
    exp = ref_ref.validate_bitsets_ref(jnp.asarray(read),
                                       jnp.asarray(written))
    assert got.dtype == torch.bool and got.shape == (k,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(exp))


@pytest.mark.parametrize("bk,bw", [(1, 1), (4, 2)])
def test_plain_matches_pallas_interpret(bk, bw):
    rng = np.random.default_rng(bk + bw)
    k, w = bk * ref_val.BK, bw * ref_val.BW
    read, written = _bits(rng, k, w, 0.1), _bits(rng, 1, w, 0.05)[0]
    got = validate.validate_bitsets(torch.from_numpy(read),
                                    torch.from_numpy(written))
    exp = ref_val.validate_bitsets(jnp.asarray(read), jnp.asarray(written),
                                   interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(exp))
    assert got.any() and not got.all()


def test_plain_works_in_row_blocks():
    """More rows than one block of the plain version holds."""
    rng = np.random.default_rng(9)
    w = ref._BLOCK_ELEMS // 64 + 5
    read, written = _bits(rng, 200, w, 1e-4), _bits(rng, 1, w, 1e-3)[0]
    got = ref.validate_bitsets_ref(torch.from_numpy(read),
                                   torch.from_numpy(written))
    exp = ((read & written[None, :]) != 0).any(axis=1)
    np.testing.assert_array_equal(got.numpy(), exp)


def _addr_sets(rng, k, length, n_objects, written_len):
    ra = rng.integers(0, n_objects, (k, length)).astype(np.int32)
    # repeated addresses within a row, and words holding bit 31
    ra[:, ::3] = ra[:, :1]
    ra[::4, -1] = 31
    rn = rng.integers(0, length + 1, (k,)).astype(np.int32)
    rn[0] = 0                       # a row with nothing read
    wa = rng.integers(0, n_objects, (written_len,)).astype(np.int32)
    wa[::2] = wa[0]
    wa[1] = 31
    return ra, rn, wa


@pytest.mark.parametrize("k,length,n_objects,written_len,written_n", [
    (1, 1, 32, 4, 4), (8, 4, 64, 8, 5), (13, 6, 300, 12, 0),
    (32, 16, 4096, 64, 64), (40, 3, 8192, 40, 17), (9, 50, 33, 30, 30),
])
def test_validate_matches_reference(k, length, n_objects, written_len,
                                    written_n):
    rng = np.random.default_rng(k * 31 + length)
    ra, rn, wa = _addr_sets(rng, k, length, n_objects, written_len)
    got = ops.validate(torch.from_numpy(ra), torch.from_numpy(rn),
                       torch.from_numpy(wa), written_n, n_objects)
    exp = ref_ops.validate(jnp.asarray(ra), jnp.asarray(rn), jnp.asarray(wa),
                           jnp.asarray(written_n, jnp.int32), n_objects)
    np.testing.assert_array_equal(got.numpy(), np.asarray(exp))
    sets = [set(ra[i, :rn[i]].tolist()) & set(wa[:written_n].tolist())
            for i in range(k)]
    np.testing.assert_array_equal(got.numpy(), [bool(s) for s in sets])
    # written_n as a () tensor, as the reference passes it
    again = ops.validate(torch.from_numpy(ra), torch.from_numpy(rn),
                         torch.from_numpy(wa),
                         torch.tensor(written_n, dtype=torch.int32),
                         n_objects)
    assert torch.equal(again, got)


def test_empty_written_set_validates_everything():
    ra = torch.arange(24, dtype=torch.int32).reshape(8, 3)
    out = ops.validate(ra, torch.full((8,), 3, dtype=torch.int32),
                       torch.zeros((4,), dtype=torch.int32), 0, 64)
    assert not out.any()


@pytest.mark.parametrize("length,n_objects", [(4096, 5000), (4096, 1 << 20),
                                              (1000, 64)])
def test_packing_long_rows_matches_reference(length, n_objects):
    """The sort-based duplicate removal on rows of thousands of slots,
    dense with repeats where n_objects is small."""
    rng = np.random.default_rng(length + n_objects)
    k = 3
    addrs = rng.integers(0, n_objects, (k, length)).astype(np.int32)
    n = np.array([length, length // 2, 0], np.int32)
    got = validate.pack_addr_sets(torch.from_numpy(addrs),
                                  torch.from_numpy(n), n_objects)
    exp = ref_val.pack_addr_sets(jnp.asarray(addrs), jnp.asarray(n),
                                 n_objects)
    np.testing.assert_array_equal(got.numpy(), np.asarray(exp))
    # the masked form with a mask that is no prefix
    valid = rng.random((k, length)) < 0.5
    got = validate.pack_addr_sets_masked(torch.from_numpy(addrs),
                                         torch.from_numpy(valid), n_objects)
    exp = ref_val.pack_addr_sets_masked(jnp.asarray(addrs),
                                        jnp.asarray(valid), n_objects)
    np.testing.assert_array_equal(got.numpy(), np.asarray(exp))


def test_plain_versions_are_not_counted_as_launches():
    validate.reset_launches()
    rng = np.random.default_rng(0)
    read = torch.from_numpy(_bits(rng, 8, 4, 0.3))
    validate.validate_bitsets(read, read[0])
    ops.validate(torch.zeros((2, 2), dtype=torch.int32),
                 torch.ones(2, dtype=torch.int32),
                 torch.zeros(2, dtype=torch.int32), 1, 64)
    assert validate.LAUNCHES == {"validate_bitsets": 0}


def test_wrapper_refuses_what_the_kernel_does_not_take():
    read = torch.zeros((8, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        validate.validate_bitsets(read.long(), read[0].long())
    with pytest.raises(ValueError):
        validate.validate_bitsets(read[0], read[0])         # rank 1 reads
    with pytest.raises(ValueError):
        validate.validate_bitsets(read, read[:2])           # rank 2 written
    with pytest.raises(ValueError):
        validate.validate_bitsets(read, read[0, :3])        # word count
    with pytest.raises(ValueError):
        validate.validate_bitsets(read, read[0].float())
    with pytest.raises(ValueError):
        validate.validate_bitsets(read.to("meta"), read[0].to("meta"))
    with pytest.raises(ValueError):
        validate.validate_bitsets(read, read[0].to("meta"))
