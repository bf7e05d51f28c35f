"""Ordered paged commit of one decode step: the wrapper around the
hand-written Hopper kernel of ``csrc/kv_commit.cu``.

During batched decoding each active slot appends its new row to a page
of a shared paged store.  Under Pot the slots' commits are preordered:
they apply in array (= sequence) order, so where two slots hit one row
or one page the later one wins, and each committed page's version
becomes the sequence number of its last writer.

    cache (P, page, H) f32 or bf16, versions (P,) int32, rows (S, H) f32,
    page_idx / row_idx / sn / commit (S,) int32

``kv_commit_`` commits in place; ``kv_commit`` commits into copies, as
the reference's functional kernel returns new arrays.  Each takes CPU
tensors to its plain version in :mod:`repro_torch.kernels.ref` and CUDA
tensors to the kernel, or raises; there is no fallback from one to the
other.  ``LAUNCHES`` counts kernel launches (never plain-version calls).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

LAUNCHES = {"kv_commit": 0}
_ENTRY = {torch.float32: "pot_kv_commit_f32",
          torch.bfloat16: "pot_kv_commit_bf16"}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check(cache, versions, rows, meta) -> None:
    # every launch passes here, so each test reads as few attributes as
    # it can: the dtypes first, then one shape, then the devices
    if cache.dtype not in _ENTRY or cache.dim() != 3:
        raise ValueError(f"cache must be (P, page, H) float32 or bfloat16, "
                         f"got {cache.dtype} {tuple(cache.shape)}")
    n_pages, _, h = cache.shape
    if versions.dtype != torch.int32 or versions.shape != (n_pages,):
        raise ValueError(f"versions must be ({n_pages},) int32, got "
                         f"{versions.dtype} {tuple(versions.shape)}")
    if rows.dtype != torch.float32 or rows.dim() != 2 or rows.shape[1] != h:
        raise ValueError(f"rows must be (S, {h}) float32, got {rows.dtype} "
                         f"{tuple(rows.shape)}")
    slots = rows.shape[:1]
    device = cache.device
    if versions.device != device or rows.device != device:
        raise ValueError(f"tensors on {versions.device}, {rows.device} and "
                         f"{device}")
    for t in meta:
        if t.dtype != torch.int32 or t.shape != slots:
            raise ValueError(f"slot metadata must be ({slots[0]},) int32, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if t.device != device:
            raise ValueError(f"tensors on {t.device} and {device}")
    if not (cache.is_contiguous() and versions.is_contiguous()):
        raise ValueError("cache and versions must be contiguous")


def kv_commit_(cache: torch.Tensor, versions: torch.Tensor,
               rows: torch.Tensor, page_idx: torch.Tensor,
               row_idx: torch.Tensor, sn: torch.Tensor, commit: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Apply one decode step's slot commits to ``cache`` and ``versions``
    in place and return them.  A slot commits where ``commit != 0`` and
    ``0 <= page_idx < P``; its row id is placed as
    :func:`repro_torch.kernels.ref.page_row` says."""
    _check(cache, versions, rows, (page_idx, row_idx, sn, commit))
    if not _build.on_card(cache, "kv_commit"):
        return ref.kv_commit_ref_(cache, versions, rows, page_idx, row_idx,
                                  sn, commit)
    n_slots = rows.shape[0]
    if n_slots == 0:
        return cache, versions
    # the names hold the contiguous tensors until the kernel is enqueued
    rows, page_idx, row_idx = (rows.contiguous(), page_idx.contiguous(),
                               row_idx.contiguous())
    sn, commit = sn.contiguous(), commit.contiguous()
    n_pages, page, h = cache.shape
    _build.launch("kv_commit", _ENTRY[cache.dtype], cache.device,
                  cache.data_ptr(), versions.data_ptr(), rows.data_ptr(),
                  page_idx.data_ptr(), row_idx.data_ptr(), sn.data_ptr(),
                  commit.data_ptr(), n_pages, page, h, n_slots)
    LAUNCHES["kv_commit"] += 1
    return cache, versions


def kv_commit(cache, versions, rows, page_idx, row_idx, sn, commit):
    """Functional :func:`kv_commit_`: commits into copies of ``cache`` and
    ``versions`` and returns them; the inputs are left as they were."""
    return kv_commit_(cache.clone(), versions.clone(), rows, page_idx,
                      row_idx, sn, commit)


def empty_launch(device) -> None:
    """Launch an empty kernel through the same path: the floor against
    which the commit's time is read (not counted in ``LAUNCHES``)."""
    _build.launch("kv_commit", "pot_empty_launch", torch.device(device))
