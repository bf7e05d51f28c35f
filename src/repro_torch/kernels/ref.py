"""Plain PyTorch versions of the hand-written conflict-table kernels.

They compute exactly what ``csrc/conflict.cu`` computes and are what the
kernel wrappers in :mod:`repro_torch.kernels.conflict` run on CPU
tensors.  The full (M, N, W) broadcast of the reference's
``conflict_matrix_bits_ref`` is 34 G elements at the main path's shapes
(K = 1024, W = 32768), so both work in blocks of rows and words whose
broadcast stays under ``_BLOCK_ELEMS`` elements.
"""

from __future__ import annotations

import torch

_BLOCK_ELEMS = 1 << 24


def conflict_matrix_bits_pair_ref(foot_bits: torch.Tensor,
                                  write_bits: torch.Tensor) -> torch.Tensor:
    """(M, N) bool: out[i, j] = any_w(foot_bits[i, w] & write_bits[j, w])
    for foot_bits (M, W) and write_bits (N, W) int32."""
    m, w = foot_bits.shape
    n = write_bits.shape[0]
    out = torch.zeros((m, n), dtype=torch.bool, device=foot_bits.device)
    if m == 0 or n == 0 or w == 0:
        return out
    wc = max(1, min(w, _BLOCK_ELEMS // max(n, 1)))
    rc = max(1, _BLOCK_ELEMS // (n * wc))
    for r0 in range(0, m, rc):
        rows = out[r0:r0 + rc]
        for w0 in range(0, w, wc):
            f = foot_bits[r0:r0 + rc, None, w0:w0 + wc]
            rows |= ((f & write_bits[None, :, w0:w0 + wc]) != 0).any(dim=2)
    return out


def conflict_matrix_bits_delta_ref(foot_bits: torch.Tensor,
                                   write_bits: torch.Tensor,
                                   old: torch.Tensor,
                                   live: torch.Tensor) -> torch.Tensor:
    """(K, K) bool incremental table: entry (i, j) is the pair verdict of
    :func:`conflict_matrix_bits_pair_ref` where ``live[i] | live[j]`` and
    ``old[i, j]`` elsewhere.  ``old`` (K, K) and ``live`` (K,) are bool."""
    fresh = conflict_matrix_bits_pair_ref(foot_bits, write_bits)
    refresh = live[:, None] | live[None, :]
    return torch.where(refresh, fresh, old)
