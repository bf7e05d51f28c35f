"""Transactional object store (TStore), dense layout.

The PyTorch port of the dense half of ``repro.core.tstore``:

* ``values``   (O, S) int32 — O objects, each a slot-vector of S words;
* ``versions`` (O,)   int32 — per-object version = sequence number of the
  last committed writer (0 = initial state);
* ``gv``       ()     int32 — global version = sequence number of the
  last committed transaction.

The sharded layout is not ported yet; the dense store is the one-shard
case of the reference's layout abstraction.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class TStore:
    values: torch.Tensor    # (O, S) int32
    versions: torch.Tensor  # (O,)   int32
    gv: torch.Tensor        # ()     int32

    @property
    def n_objects(self) -> int:
        return self.values.shape[0]

    @property
    def slot(self) -> int:
        return self.values.shape[1]

    @property
    def device(self) -> torch.device:
        return self.values.device


def store_with(store: TStore, values, versions, gv) -> TStore:
    """Rebuild a store around new contents."""
    return dataclasses.replace(store, values=values, versions=versions,
                               gv=gv)


def make_store(n_objects: int, slot: int = 1, init=None, *,
               device="cuda") -> TStore:
    """Create a fresh store on ``device``.  ``init`` is an optional (O, S)
    initial image."""
    if init is None:
        values = torch.zeros((n_objects, slot), dtype=torch.int32,
                             device=device)
    else:
        values = torch.as_tensor(np.asarray(init, np.int32)).reshape(
            n_objects, -1).to(device)
    return TStore(
        values=values,
        versions=torch.zeros((n_objects,), dtype=torch.int32, device=device),
        gv=torch.zeros((), dtype=torch.int32, device=device))


def dense_image(store: TStore) -> torch.Tensor:
    """The (O, slot) committed image."""
    return store.values


_FNV_OFFSET = 0x811C9DC5
_FNV_PRIME = 0x01000193
_MASK32 = 0xFFFFFFFF


def fingerprint(store: TStore) -> int:
    """Order-sensitive 32-bit FNV-1a of the store image (one step per
    int32 word, row-major), bitwise equal to the reference's.

    Computed on the host in integer arithmetic masked to 32 bits: the
    hash is a sequential chain, and one device launch per word would
    cost far more than the host loop."""
    words = dense_image(store).reshape(-1).cpu().numpy().view(np.uint32)
    h = _FNV_OFFSET
    for x in words.tolist():
        h = ((h ^ x) * _FNV_PRIME) & _MASK32
    return h
