"""Bit-packing of address sets (after ``repro.kernels.validate``).

A (K, L) array of addresses becomes (K, ceil(O/32)) int32 words, bit
``a % 32`` of word ``a // 32`` set for each valid address ``a``.  Words
with bit 31 set are negative int32 values, exactly as in the reference.
These are torch ops, not a hand-written kernel: the reference packs with
XLA ops too.  The TL2 validation kernel of that module is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

# _BITS[b] = the int32 word with only bit b set (bit 31 is INT_MIN)
_BITS = torch.from_numpy(
    (np.uint32(1) << np.arange(32, dtype=np.uint32)).view(np.int32))


def pack_addr_sets(addrs: torch.Tensor, n: torch.Tensor,
                   n_objects: int) -> torch.Tensor:
    """Bit-pack (K, L) address sets whose first ``n[k]`` slots are valid."""
    length = addrs.shape[1]
    valid = (torch.arange(length, device=addrs.device)[None, :]
             < n[:, None])
    return pack_addr_sets_masked(addrs, valid, n_objects)


def pack_addr_sets_masked(addrs: torch.Tensor, valid: torch.Tensor,
                          n_objects: int) -> torch.Tensor:
    """Bit-pack (K, L) address sets under an explicit (K, L) mask.  Valid
    addresses must lie in [0, n_objects); invalid slots may hold any
    value and set no bit."""
    k, length = addrs.shape
    w = -(-n_objects // 32)
    dev = addrs.device
    addrs = addrs.long()
    slots = torch.arange(length, device=dev)
    # an address repeated within a row sets its bit once: keep its first
    # valid slot only, so the distinct bits of a word can be summed
    # (without carries, a sum of distinct powers of two is their OR)
    repeat = ((addrs[:, :, None] == addrs[:, None, :]) & valid[:, None, :]
              & (slots[None, :] < slots[:, None])[None]).any(dim=2)
    keep = valid & ~repeat
    rows = torch.arange(k, device=dev)[:, None]
    flat = torch.where(keep, rows * w + addrs // 32, 0)
    bit = torch.where(keep, _BITS.to(dev)[addrs % 32], 0)
    bits = torch.zeros((k * w,), dtype=torch.int32, device=dev)
    bits.index_add_(0, flat.reshape(-1), bit.reshape(-1))
    return bits.reshape(k, w)
