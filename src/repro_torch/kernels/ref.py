"""Plain PyTorch versions of the hand-written kernels.

They compute exactly what ``csrc/conflict.cu``, ``csrc/validate.cu``,
``csrc/kv_commit.cu`` and ``csrc/fused_adamw.cu`` compute and are what
the kernel wrappers in :mod:`repro_torch.kernels.conflict`,
:mod:`repro_torch.kernels.validate`, :mod:`repro_torch.kernels.kv_commit`
and :mod:`repro_torch.kernels.fused_adamw` run on CPU tensors.  The
full (M, N, W) broadcast of the reference's ``conflict_matrix_bits_ref``
is 34 G elements at the main path's shapes (K = 1024, W = 32768), so the
conflict and validation versions work in blocks of rows and words whose
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


def validate_bitsets_ref(read_bits: torch.Tensor,
                         written_bits: torch.Tensor) -> torch.Tensor:
    """(K,) bool: out[k] = any_w(read_bits[k, w] & written_bits[w]) for
    read_bits (K, W) and written_bits (W,) int32 (TL2 read-set
    validation)."""
    k, w = read_bits.shape
    out = torch.zeros((k,), dtype=torch.bool, device=read_bits.device)
    rc = max(1, _BLOCK_ELEMS // max(w, 1))
    for r0 in range(0, k, rc):
        out[r0:r0 + rc] = ((read_bits[r0:r0 + rc] & written_bits[None, :])
                           != 0).any(dim=1)
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


def page_row(r: int, page: int) -> int:
    """The row a row id lands on, as ``lax.dynamic_update_slice`` places
    it: a negative id counts from the end of the page once, then the
    result is clamped to ``[0, page - 1]`` (row -1 of 4 is row 3, row -5
    of 4 and row 9 of 4 are rows 0 and 3)."""
    if r < 0:
        r += page
    return min(max(r, 0), page - 1)


def kv_commit_ref_(cache: torch.Tensor, versions: torch.Tensor,
                   rows: torch.Tensor, page_idx: torch.Tensor,
                   row_idx: torch.Tensor, sn: torch.Tensor,
                   commit: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Apply the slot commits one by one in array order, in place.

    Slot s with ``commit[s] != 0`` and ``0 <= page_idx[s] < P`` writes
    ``rows[s]`` (cast to the cache dtype) at row :func:`page_row` of
    ``row_idx[s]``, and sets ``versions[page_idx[s]] = sn[s]``; the last
    such slot wins.  This is the Pallas kernel's fold
    (``repro/kernels/kv_commit.py``): a negative page id is dropped, not
    wrapped as ``repro.kernels.ref.kv_commit_ref`` wraps it."""
    n_pages, page, _ = cache.shape
    meta = torch.stack([page_idx, row_idx, sn, commit]).tolist()
    for s, (p, r, v, c) in enumerate(zip(*meta)):
        if c != 0 and 0 <= p < n_pages:
            cache[p, page_row(r, page)] = rows[s].to(cache.dtype)
            versions[p] = v
    return cache, versions


def kv_commit_ref(cache, versions, rows, page_idx, row_idx, sn, commit):
    """Functional :func:`kv_commit_ref_`: commits into copies."""
    return kv_commit_ref_(cache.clone(), versions.clone(), rows, page_idx,
                          row_idx, sn, commit)


def adamw_ref(p, m, v, g, hp):
    """One AdamW step, ``(p', m', v')``, with the hyperparameters read from
    the (1, 8) float32 vector ``hp`` = [lr, b1, b2, eps, wd, bc1, bc2, rv]
    on the tensors' device.

    The operations and their order are the Pallas kernel's
    (``repro/kernels/fused_adamw.py``), each one rounded to float32:
    ``1 - b1`` is the float32 difference of float32 ``b1`` (0.100000024
    for 0.9), where ``repro.kernels.ref.adamw_ref`` takes it from the
    Python float (float32 0.1)."""
    lr, b1, b2, eps, wd, bc1, bc2 = hp[0, :7]
    g = g.float()
    m2 = b1 * m + (1.0 - b1) * g
    v2 = b2 * v + (1.0 - b2) * g * g
    mhat = m2 / bc1
    vhat = v2 / bc2
    p2 = p - lr * (mhat / (torch.sqrt(vhat) + eps) + wd * p)
    return p2, m2, v2


def adamw_speculative_ref(p, m, v, g, versions, hp, block=256):
    """:func:`adamw_ref` on each (block, block) block of a (R, C) leaf
    whose version, converted to float32, is at most ``hp[0, 7]`` (the
    read version ``rv``); a stale block keeps p, m and v.  Returns
    ``(p', m', v', abort)``, abort (R / block, C / block) int32.

    The Pallas kernel compares in float32, so above 2^24 a version may
    round down to ``rv``: version 2^24 + 1 against rv 2^24 is not stale
    here, though ``repro.kernels.ref.adamw_speculative_ref``, comparing
    integers, finds it stale."""
    p2, m2, v2 = adamw_ref(p, m, v, g, hp)
    stale = versions.float() > hp[0, 7]
    gr, gc = stale.shape
    big = stale[:, None, :, None].expand(gr, block, gc, block).reshape(
        p.shape)
    return (torch.where(big, p, p2), torch.where(big, m, m2),
            torch.where(big, v, v2), stale.to(torch.int32))
