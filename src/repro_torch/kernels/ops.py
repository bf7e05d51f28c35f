"""Plumbing around the kernels, after ``repro.kernels.ops``: TL2 read-set
validation (``validate``), the conflict-table updates of the round
protocol (dense store, and their ``*_sharded`` twins, one kernel call a
shard at the shard-local width), the rectangular conflict strips of DeSTM's
retry waves (``cross_conflicts``), the cross-batch validation of
pipelined sessions (``spec_read_invalid``), the ordered paged commit of the
serving path (``kv_cache_commit_`` in place, ``kv_cache_commit`` into
copies) and the fused AdamW commit of the
training path (``adamw_update`` and its speculative variant).

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
from repro_torch.kernels import fused_adamw as _adamw
from repro_torch.kernels import kv_commit as _kvc
from repro_torch.kernels import validate as _val
from repro_torch.runtime import shardings


def _on_cuda(t: torch.Tensor) -> bool:
    """True when ``t`` lives on a CUDA device: the matrix formulation,
    carried by the hand-written kernels."""
    return t.device.type == "cuda"


def validate(read_addrs: torch.Tensor, read_n: torch.Tensor,
             written_addrs: torch.Tensor, written_n,
             n_objects: int) -> torch.Tensor:
    """Read-set validation of K transactions against one written set:
    read_addrs (K, L) with read_n (K,) valid slots, written_addrs (Lw,)
    with written_n (a number or a () tensor) valid slots.  Returns
    conflict (K,) bool, through the validation kernel on CUDA tensors and
    its plain version on CPU ones."""
    read_bits = _val.pack_addr_sets(read_addrs, read_n, n_objects)
    wn = torch.as_tensor(written_n, device=written_addrs.device).reshape(1)
    written_bits = _val.pack_addr_sets(written_addrs[None, :], wn,
                                       n_objects)[0]
    return _val.validate_bitsets(read_bits, written_bits)


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


# --------------------------------------------------------------------------
# Shard-partitioned conflict analysis
# --------------------------------------------------------------------------
#
# Under the sharded layout (tstore.StoreLayout: S contiguous range shards
# of C = ceil(O/S) objects) each shard packs only the addresses in its
# range into (K, ceil(C/32)) words, and the global verdict is the OR
# over shards,
#
#     footprint(i) ∩ writes(j) ≠ ∅  ⟺  ∃s: foot_s(i) ∩ writes_s(j) ≠ ∅,
#
# because the shards partition the address space.  Each function below
# is the per-shard twin of a dense one above: one call of a kernel
# wrapper per shard at W_s = ceil(C/32) words (the kernel on CUDA
# tensors, its plain version on CPU ones), OR-reduced.  The packed words
# keep the reference's (S, K, W_s) int32 layout.  Under a mesh (one shard
# per rank, ``tstore.StoreLayout.mesh``) a rank packs and launches only
# its own shard's strips, (1, K, W_s), and the OR over shards crosses
# ranks (``_or_ranks``: an all-gather, then the OR in rank order).


def _or_ranks(t: torch.Tensor, layout) -> torch.Tensor:
    """The OR of a bool tensor over the ranks of ``layout``'s mesh (the
    tensor itself without one)."""
    if layout is None or layout.mesh is None:
        return t
    parts = shardings.gather(t.view(torch.uint8)[None],
                             layout.mesh.get_group(), 0)
    out = parts[0].clone()
    for p in parts[1:]:
        out |= p
    return out.view(torch.bool)


def _pack_sharded(addrs: torch.Tensor, valid: torch.Tensor,
                  layout) -> torch.Tensor:
    """(S, K, W_s) int32: each shard's bit-packing of the valid (K, L)
    addresses in its range, at shard-local bits.  One packing over
    S·W_s words, address a at bit offset_of(a) of shard_of(a)'s words,
    then split into the shards.  Under a mesh (1, K, W_s): the rank's
    own shard only."""
    span = layout.words_per_shard * 32
    if layout.mesh is not None:
        mine = valid & (layout.shard_of(addrs) == layout.rank)
        return _val.pack_addr_sets_masked(layout.offset_of(addrs), mine,
                                          span)[None]
    local = layout.shard_of(addrs) * span + layout.offset_of(addrs)
    bits = _val.pack_addr_sets_masked(local, valid, layout.shards * span)
    k = addrs.shape[0]
    return bits.view(k, layout.shards, -1).transpose(0, 1).contiguous()


def packed_footprints_sharded(raddrs, rn, waddrs, wn, layout
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-shard bit-packing of a batch's (footprint, write-set) address
    sets: (S, K, W_s) int32 words each."""
    slot = torch.arange(raddrs.shape[1], device=raddrs.device)[None, :]
    rb = _pack_sharded(raddrs, slot < rn[:, None], layout)
    wb = _pack_sharded(waddrs, slot < wn[:, None], layout)
    return rb | wb, wb


def update_packed_footprints_sharded(foot_bits, write_bits, raddrs, rn,
                                     waddrs, wn, live: torch.Tensor, layout
                                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sharded twin of :func:`update_packed_footprints`: re-pack the live
    rows in every shard, keep the settled rows' words."""
    fresh_foot, fresh_write = packed_footprints_sharded(
        raddrs, torch.where(live, rn, 0), waddrs, torch.where(live, wn, 0),
        layout)
    keep = live[None, :, None]
    return (torch.where(keep, fresh_foot, foot_bits),
            torch.where(keep, fresh_write, write_bits))


def update_packed_footprints_compact_sharded(foot_bits, write_bits, raddrs,
                                             rn, waddrs, wn,
                                             idx: torch.Tensor,
                                             valid: torch.Tensor, layout
                                             ) -> tuple[torch.Tensor,
                                                        torch.Tensor]:
    """Sharded twin of :func:`update_packed_footprints_compact`: pack the
    gathered block per shard and scatter each shard's rows over the
    carried (S, K, W_s) words at rows ``idx`` (gather padding masked)."""
    cfoot, cwrite = packed_footprints_sharded(
        raddrs, torch.where(valid, rn, 0), waddrs, torch.where(valid, wn, 0),
        layout)
    rows = idx[valid]

    def scatter(dst, src):
        out = dst.clone()
        out[:, rows] = src[:, valid]
        return out

    return scatter(foot_bits, cfoot), scatter(write_bits, cwrite)


def conflict_matrix_sharded(foot_bits: torch.Tensor,
                            write_bits: torch.Tensor) -> torch.Tensor:
    """(K, K) table from per-shard packed sets (S, K, W_s): the OR over
    shards of each shard's intersection (the pair kernel; on CPU tensors
    its plain version, the reference's ``_shard_intersects``)."""
    out = _conf.conflict_matrix_bits_pair(foot_bits[0], write_bits[0])
    for s in range(1, foot_bits.shape[0]):
        out |= _conf.conflict_matrix_bits_pair(foot_bits[s], write_bits[s])
    return out


def conflict_matrix_delta_sharded(foot_bits: torch.Tensor,
                                  write_bits: torch.Tensor,
                                  old: torch.Tensor,
                                  live: torch.Tensor,
                                  layout=None) -> torch.Tensor:
    """Sharded twin of :func:`conflict_matrix_delta`: the delta kernel
    once per shard against ``old``, OR-reduced.  A stale entry ORs
    ``old`` with itself; a refreshed one is the OR of the shards'
    verdicts.  (The kernel REPLACES a refreshed entry, so no shard's
    output may feed the next one's ``old``.)"""
    out = _conf.conflict_matrix_bits_delta(foot_bits[0], write_bits[0],
                                           old, live)
    for s in range(1, foot_bits.shape[0]):
        out |= _conf.conflict_matrix_bits_delta(foot_bits[s], write_bits[s],
                                                old, live)
    return _or_ranks(out, layout)


def conflict_matrix_delta_compact_sharded(foot_bits: torch.Tensor,
                                          write_bits: torch.Tensor,
                                          old: torch.Tensor,
                                          idx: torch.Tensor,
                                          valid: torch.Tensor,
                                          layout=None) -> torch.Tensor:
    """Sharded twin of :func:`conflict_matrix_delta_compact`: the (C, K)
    row strip and the (K, C) column strip, each the OR over shards of
    the pair kernel's per-shard strips, scattered over ``old``.
    ``foot_bits`` / ``write_bits`` (S, K, W_s) must already hold the
    refreshed live rows."""
    row_strip = col_strip = None
    for s in range(foot_bits.shape[0]):
        fb, wb = foot_bits[s], write_bits[s]
        r = _conf.conflict_matrix_bits_pair(fb[idx], wb)
        c = _conf.conflict_matrix_bits_pair(fb, wb[idx])
        row_strip = r if row_strip is None else row_strip | r
        col_strip = c if col_strip is None else col_strip | c
    row_strip = _or_ranks(row_strip, layout)
    col_strip = _or_ranks(col_strip, layout)
    new = scatter_rows(old, row_strip, idx, valid)
    # column twin of scatter_rows: gather padding is masked, not scattered
    new[:, idx[valid]] = col_strip[:, valid]
    return new


def cross_conflicts(reader_raddrs: torch.Tensor, reader_rn: torch.Tensor,
                    reader_waddrs: torch.Tensor, reader_wn: torch.Tensor,
                    writer_waddrs: torch.Tensor, writer_wn: torch.Tensor,
                    n_objects: int, reads_only: bool = False
                    ) -> torch.Tensor:
    """Rectangular reader x writer conflict strip, (R, C) bool: entry
    (i, j) means reader row i's footprint (reads and writes, or its
    logged reads alone with ``reads_only``) intersects writer row j's
    write set.  Both sides are bit-packed and the strip is one pair-kernel
    call: the kernel on CUDA tensors, and on CPU ones its plain version,
    the dense bit-ops form the reference takes off the TPU (same
    verdicts)."""
    rbits = _val.pack_addr_sets(reader_raddrs, reader_rn, n_objects)
    if not reads_only:
        rbits = rbits | _val.pack_addr_sets(reader_waddrs, reader_wn,
                                            n_objects)
    wbits = _val.pack_addr_sets(writer_waddrs, writer_wn, n_objects)
    return _conf.conflict_matrix_bits_pair(rbits, wbits)


# --------------------------------------------------------------------------
# Cross-batch speculative validation
# --------------------------------------------------------------------------
#
# A pipelined session executes batch n+1 against the store as it stood
# before batch n committed.  Version stamps are globally monotone
# sequence numbers, so an address was written after the snapshot iff
# versions[a] > snap_gv.  A speculated row stays valid iff none of its
# logged READ addresses is dirty (a row's execution is a pure function of
# the values it reads).  The dirty set packs into one bitset row, and the
# verdict is any_w(read_bits[k, w] & dirty_words[w]): the function of the
# validation kernel.


def spec_dirty_words(versions: torch.Tensor, snap_gv,
                     n_objects: int) -> torch.Tensor:
    """Bit-pack the post-snapshot dirty set: bit ``a % 32`` of word
    ``a // 32`` is set iff ``versions[a] > snap_gv``.  Returns
    (ceil(O/32),) int32; a word with bit 31 set is negative, as in
    ``validate.pack_addr_sets``.  The distinct bits of a word are summed
    in int32, bit 31 as INT_MIN: no partial sum of distinct bits leaves
    the int32 range, so no unsigned sum is needed."""
    w = -(-n_objects // 32)
    dirty = versions.reshape(-1)[:n_objects] > snap_gv
    dirty = torch.nn.functional.pad(dirty, (0, w * 32 - n_objects))
    bits = _val._BITS.to(dirty.device)
    return torch.where(dirty.reshape(w, 32), bits, 0).sum(
        dim=1, dtype=torch.int32)


def spec_read_invalid(raddrs: torch.Tensor, rn: torch.Tensor,
                      versions: torch.Tensor, snap_gv,
                      n_objects: int) -> torch.Tensor:
    """Cross-batch read-set validation: (K,) bool, True where a row's
    logged read set hits an address written after the snapshot
    (``versions > snap_gv``).  On CUDA tensors the read sets and the
    dirty words are packed and the validation kernel gives the verdict;
    on CPU ones the reference's dense version gather (same verdicts)."""
    if not _on_cuda(raddrs):
        valid = (torch.arange(raddrs.shape[1], device=raddrs.device)[None, :]
                 < rn[:, None])
        dirty = versions.reshape(-1)[:n_objects] > snap_gv
        return (valid & dirty[torch.where(valid, raddrs, 0).long()]).any(1)
    read_bits = _val.pack_addr_sets(raddrs, rn, n_objects)
    return _val.validate_bitsets(
        read_bits, spec_dirty_words(versions, snap_gv, n_objects))


def spec_dirty_words_sharded(versions: torch.Tensor, snap_gv,
                             layout) -> torch.Tensor:
    """Per-shard twin of :func:`spec_dirty_words`: shard s's words span
    only its own range, at shard-local bits.  versions (S, C) ->
    (S, W_s) int32 (under a mesh (1, C) -> (1, W_s), the rank's shard).
    Padding rows are never stamped (version 0), hence never dirty."""
    w = layout.words_per_shard
    dirty = torch.nn.functional.pad(versions > snap_gv,
                                    (0, w * 32 - layout.shard_size))
    bits = _val._BITS.to(dirty.device)
    return torch.where(dirty.reshape(-1, w, 32), bits, 0).sum(
        dim=2, dtype=torch.int32)


def spec_read_invalid_sharded(raddrs: torch.Tensor, rn: torch.Tensor,
                              versions: torch.Tensor, snap_gv,
                              layout) -> torch.Tensor:
    """Sharded twin of :func:`spec_read_invalid`: per-shard read bits
    against per-shard dirty words through the validation kernel (its
    plain version on CPU tensors), OR-reduced (across ranks under a
    mesh); a dirty read lands in exactly one shard."""
    valid = (torch.arange(raddrs.shape[1], device=raddrs.device)[None, :]
             < rn[:, None])
    read_bits = _pack_sharded(raddrs, valid, layout)
    dwords = spec_dirty_words_sharded(versions, snap_gv, layout)
    out = _val.validate_bitsets(read_bits[0], dwords[0])
    for s in range(1, read_bits.shape[0]):
        out |= _val.validate_bitsets(read_bits[s], dwords[s])
    return _or_ranks(out, layout)


def kv_cache_commit(cache, versions, rows, page_idx, row_idx, sn, commit):
    """Ordered paged commit of one decode step (see ``kv_commit.py``):
    the kernel for CUDA tensors, its plain version for CPU ones.  Returns
    new ``(cache, versions)``; the inputs are left as they were."""
    return _kvc.kv_commit(cache, versions, rows, page_idx, row_idx, sn,
                          commit)


def kv_cache_commit_(cache, versions, rows, page_idx, row_idx, sn, commit):
    """:func:`kv_cache_commit` in place: commits into ``cache`` and
    ``versions`` and returns them, writing only the committed rows and
    versions (the serving step's route: no copy of the store)."""
    return _kvc.kv_commit_(cache, versions, rows, page_idx, row_idx, sn,
                           commit)


def adamw_update(p, m, v, g, *, step, lr=1e-3, b1=0.9, b2=0.999,
                 eps=1e-8, wd=0.01):
    """Fast-mode fused AdamW over a float32 parameter leaf of any shape
    (``g`` float32 or bfloat16): returns new ``(p, m, v)``.  ``step`` is
    the step being taken (1 for the first), a number or a tensor on the
    leaf's device.  The update is elementwise, so no leaf is padded: the
    kernel takes any length."""
    hp = _adamw.hp_vector(step, lr=lr, b1=b1, b2=b2, eps=eps, wd=wd,
                          device=p.device)
    return _adamw.fused_adamw(p, m, v, g, hp)


def adamw_update_speculative(p, m, v, g, versions, rv, *, step, lr=1e-3,
                             b1=0.9, b2=0.999, eps=1e-8, wd=0.01):
    """Speculative fused AdamW of a (R, C) leaf, R and C multiples of 256:
    ``versions`` (R / 256, C / 256) int32, ``rv`` the read version (a
    number or a tensor).  Returns new ``(p, m, v, abort)``."""
    hp = _adamw.hp_vector(step, lr=lr, b1=b1, b2=b2, eps=eps, wd=wd, rv=rv,
                          device=p.device)
    return _adamw.fused_adamw_speculative(p, m, v, g, versions, hp)
