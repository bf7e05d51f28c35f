"""TL2 read-set validation over bit-packed address sets (after
``repro.kernels.validate``): the packing of address sets and the wrapper
around the hand-written Hopper kernel of ``csrc/validate.cu``.

A (K, L) array of addresses becomes (K, ceil(O/32)) int32 words, bit
``a % 32`` of word ``a // 32`` set for each valid address ``a``.  Words
with bit 31 set are negative int32 values, exactly as in the reference.
The packing is torch ops, not a hand-written kernel: the reference packs
with XLA ops too.

    conflict[k] = any_w( read_bits[k, w] & written_bits[w] )

is the validation itself (paper Fig. 3b, lines 23-26): a transaction's
read set against the set written since it read.  ``validate_bitsets``
takes CPU tensors to its plain version in :mod:`repro_torch.kernels.ref`
and CUDA tensors to the kernel, or raises; there is no fallback from one
to the other.  Any K and W are taken and nothing is padded (the Pallas
kernel needs K % 8 and W % 128 for its tiles; this kernel masks its
ragged edges).  ``LAUNCHES`` counts kernel launches, never plain-version
calls.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build, ref

LAUNCHES = {"validate_bitsets": 0}

# _BITS[b] = the int32 word with only bit b set (bit 31 is INT_MIN)
_BITS = torch.from_numpy(
    (np.uint32(1) << np.arange(32, dtype=np.uint32)).view(np.int32))


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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
    value and set no bit.

    An address repeated within a row sets its bit once: each row is
    sorted (invalid slots as -1, in front) and only the first of a run of
    equal addresses is kept, so the distinct bits of a word can be summed
    (without carries, a sum of distinct powers of two is their OR).
    O(L log L) per row."""
    k, _ = addrs.shape
    w = -(-n_objects // 32)
    dev = addrs.device
    key = torch.sort(torch.where(valid, addrs.long(), -1), dim=1).values
    prev = torch.cat([key.new_full((k, 1), -1), key[:, :-1]], dim=1)
    keep = (key >= 0) & (key != prev)
    rows = torch.arange(k, device=dev)[:, None]
    flat = torch.where(keep, rows * w + key // 32, 0)
    bit = torch.where(keep, _BITS.to(dev)[key % 32], 0)
    bits = torch.zeros((k * w,), dtype=torch.int32, device=dev)
    bits.index_add_(0, flat.reshape(-1), bit.reshape(-1))
    return bits.reshape(k, w)


def validate_bitsets(read_bits: torch.Tensor,
                     written_bits: torch.Tensor) -> torch.Tensor:
    """(K,) bool, out[k] = any_w(read_bits[k, w] & written_bits[w]), for
    read_bits (K, W) and written_bits (W,) int32 on one device.  Any K
    and W; nothing is padded."""
    if read_bits.dim() != 2 or read_bits.dtype != torch.int32:
        raise ValueError(f"read bitsets must be 2-D int32, got "
                         f"{read_bits.dtype} {tuple(read_bits.shape)}")
    k, w = read_bits.shape
    if written_bits.dtype != torch.int32 or written_bits.shape != (w,):
        raise ValueError(f"written bitset must be ({w},) int32, got "
                         f"{written_bits.dtype} {tuple(written_bits.shape)}")
    if written_bits.device != read_bits.device:
        raise ValueError(f"tensors on {read_bits.device} and "
                         f"{written_bits.device}")
    if not _build.on_card(read_bits, "validate"):
        return ref.validate_bitsets_ref(read_bits, written_bits)
    read_bits = read_bits.contiguous()
    written_bits = written_bits.contiguous()
    out = torch.empty((k,), dtype=torch.bool, device=read_bits.device)
    if k == 0:
        return out
    _build.launch("validate", "pot_validate", read_bits.device,
                  read_bits.data_ptr(), written_bits.data_ptr(),
                  out.data_ptr(), k, w)
    LAUNCHES["validate_bitsets"] += 1
    return out
