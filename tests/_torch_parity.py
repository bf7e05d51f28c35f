"""Shared helpers of the parity tests between the JAX reference
(``repro``) and the PyTorch port (``repro_torch``).

Inputs are made with numpy from a seed and handed to both packages as
numpy arrays; results come back as numpy and are compared bitwise
(everything is int32 or bool).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from repro.core.txn import TxnBatch as RefBatch
from repro.core.txn import TxnResult as RefResult
from repro_torch import convert
from repro_torch.core.engine import TRACE_FIELDS
from repro_torch.core.txn import TxnResult

RESULT_FIELDS = ("raddrs", "rn", "waddrs", "wvals", "wn")
I32_MIN, I32_MAX = -(1 << 31), (1 << 31) - 1


def random_batch(rng, k: int, length: int, n_objects: int) -> dict:
    """A (K, L) batch dict covering every opcode, indirect addressing,
    negative and out-of-range direct addresses, and operands near the
    int32 limits (so accumulators go negative and wrap)."""
    big = rng.integers(I32_MIN, I32_MAX, (k, length), endpoint=True)
    small = rng.integers(-3, 4, (k, length))
    return dict(
        opcodes=rng.integers(0, 4, (k, length)).astype(np.int32),
        addrs=rng.integers(-2 * n_objects, 2 * n_objects,
                           (k, length)).astype(np.int32),
        indirect=rng.random((k, length)) < 0.4,
        operands=np.where(rng.random((k, length)) < 0.5, big,
                          small).astype(np.int32),
        n_ins=rng.integers(0, length + 1, (k,)).astype(np.int32))


def random_values(rng, n_objects: int, slot: int) -> np.ndarray:
    return rng.integers(I32_MIN, I32_MAX, (n_objects, slot),
                        endpoint=True).astype(np.int32)


def ref_batch(arrays: dict) -> RefBatch:
    return RefBatch(**{k: jnp.asarray(v) for k, v in arrays.items()})


def port_batch(arrays: dict):
    return convert.batch_from_numpy(arrays, device="cpu")


def ref_result(res: TxnResult) -> RefResult:
    return RefResult(**{f: jnp.asarray(getattr(res, f).numpy())
                        for f in RESULT_FIELDS})


def port_result(res: RefResult) -> TxnResult:
    return TxnResult(**{f: torch.from_numpy(np.array(getattr(res, f)))
                        for f in RESULT_FIELDS})


def assert_results_equal(port, ref, msg=""):
    for f in RESULT_FIELDS:
        np.testing.assert_array_equal(
            getattr(port, f).numpy(), np.asarray(getattr(ref, f)),
            err_msg=f"{msg} field {f}")


def assert_traces_equal(port_traces, ref_traces, msg=""):
    """Every ExecTrace field of every batch, bitwise."""
    assert len(port_traces) == len(ref_traces), msg
    for i, (p, r) in enumerate(zip(port_traces, ref_traces)):
        pn = convert.trace_to_numpy(p)
        assert set(pn) == {f.name for f in dataclasses.fields(r)}
        for f in TRACE_FIELDS:
            np.testing.assert_array_equal(
                pn[f], np.asarray(getattr(r, f)),
                err_msg=f"{msg} batch {i} field {f}")
