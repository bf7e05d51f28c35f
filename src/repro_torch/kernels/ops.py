"""Conflict-table plumbing around the kernels (dense store), after
``repro.kernels.ops``.

The reference takes its Pallas kernels only on a TPU (``_on_tpu()``) and
otherwise dense fallbacks.  Here ``_on_cuda`` takes that place: the
protocol layer asks it whether to carry packed bitsets and a K x K table
(the matrix formulation the hand-written kernels serve) or to take the
scatter-min formulation.  The kernel wrappers themselves route by the
device of their tensors, so nothing here pads to a tile: the kernels
mask their ragged edges.
"""

from __future__ import annotations

import torch

from repro_torch.core.txn import scatter_rows
from repro_torch.kernels import conflict as _conf
from repro_torch.kernels import validate as _val


def _on_cuda(t: torch.Tensor) -> bool:
    """True when ``t`` lives on a CUDA device: the matrix formulation,
    carried by the hand-written kernels."""
    return t.device.type == "cuda"


def _conflict_matrix_dense(raddrs, rn, waddrs, wn, n_objects):
    """Reference formulation of :func:`conflict_matrix`: dense 0/1
    footprint masks and one matmul (exact: counts are small integers in
    float32)."""
    k, length = raddrs.shape
    slots = torch.arange(length, device=raddrs.device)

    def dense(addrs, n):
        valid = slots[None, :] < n[:, None]
        tgt = torch.where(valid, addrs.long(), n_objects)  # shadow column
        mask = torch.zeros((k, n_objects + 1), dtype=torch.float32,
                           device=raddrs.device)
        mask.scatter_(1, tgt, 1.0)
        return mask[:, :n_objects]

    wmask = dense(waddrs, wn)
    fmask = torch.maximum(dense(raddrs, rn), wmask)
    return (fmask @ wmask.T) > 0.5


def conflict_matrix(raddrs: torch.Tensor, rn: torch.Tensor,
                    waddrs: torch.Tensor, wn: torch.Tensor,
                    n_objects: int) -> torch.Tensor:
    """(K, K) bool: entry (i, j) means reads(i) ∪ writes(i) intersects
    writes(j).  On CUDA the pair kernel over packed address sets;
    elsewhere the dense-mask formulation (same verdicts)."""
    if not _on_cuda(raddrs):
        return _conflict_matrix_dense(raddrs, rn, waddrs, wn, n_objects)
    foot_bits, write_bits = packed_footprints(raddrs, rn, waddrs, wn,
                                              n_objects)
    return _conf.conflict_matrix_bits(foot_bits, write_bits)


def packed_footprints(raddrs, rn, waddrs, wn, n_objects: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Bit-pack a batch's (footprint, write-set) address sets into
    (K, ceil(O/32)) int32 words."""
    read_bits = _val.pack_addr_sets(raddrs, rn, n_objects)
    write_bits = _val.pack_addr_sets(waddrs, wn, n_objects)
    return read_bits | write_bits, write_bits


def update_packed_footprints(foot_bits, write_bits, raddrs, rn, waddrs, wn,
                             live: torch.Tensor, n_objects: int
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Re-pack only the live rows' address sets and keep the settled
    rows' words."""
    fresh_foot, fresh_write = packed_footprints(
        raddrs, torch.where(live, rn, 0), waddrs, torch.where(live, wn, 0),
        n_objects)
    keep = live[:, None]
    return (torch.where(keep, fresh_foot, foot_bits),
            torch.where(keep, fresh_write, write_bits))


def update_packed_footprints_compact(foot_bits, write_bits, raddrs, rn,
                                     waddrs, wn, idx: torch.Tensor,
                                     valid: torch.Tensor, n_objects: int
                                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Compact variant: pack the gathered (C, L) block's rows and scatter
    them over the carried (K, W) words at rows ``idx`` (``valid`` masks
    gather padding)."""
    cfoot, cwrite = packed_footprints(
        raddrs, torch.where(valid, rn, 0), waddrs, torch.where(valid, wn, 0),
        n_objects)
    return (scatter_rows(foot_bits, cfoot, idx, valid),
            scatter_rows(write_bits, cwrite, idx, valid))


def conflict_matrix_delta_compact(foot_bits: torch.Tensor,
                                  write_bits: torch.Tensor,
                                  old: torch.Tensor, idx: torch.Tensor,
                                  valid: torch.Tensor) -> torch.Tensor:
    """Refresh rows and columns ``idx`` of the carried table: the (C, K)
    strip of the C live footprints against every write set and the (K, C)
    strip of every footprint against the C live write sets, both from the
    pair kernel, scattered over ``old``.  ``foot_bits`` / ``write_bits``
    must already hold the refreshed live rows."""
    row_strip = _conf.conflict_matrix_bits_pair(foot_bits[idx], write_bits)
    col_strip = _conf.conflict_matrix_bits_pair(foot_bits, write_bits[idx])
    new = scatter_rows(old, row_strip, idx, valid)
    # column twin of scatter_rows: gather padding is masked, not scattered
    new[:, idx[valid]] = col_strip[:, valid]
    return new


def conflict_matrix_delta(foot_bits: torch.Tensor, write_bits: torch.Tensor,
                          old: torch.Tensor,
                          live: torch.Tensor) -> torch.Tensor:
    """Incremental table update over carried packed footprints: entry
    (i, j) is recomputed iff transaction i or j re-executed this round
    (``live``), otherwise ``old`` is carried — the delta kernel."""
    return _conf.conflict_matrix_bits_delta(foot_bits, write_bits, old, live)
