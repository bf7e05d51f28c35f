"""Footprint-conflict tables over bit-packed address sets: the wrappers
around the hand-written Hopper kernels of ``csrc/conflict.cu``.

    conflict[i, j] = any_w( foot_bits[i, w] & write_bits[j, w] )

``conflict_matrix_bits_pair`` computes a rectangular (M, N) table — the
(C, K) and (K, C) strips of a compact round
(``ops.conflict_matrix_delta_compact``); ``conflict_matrix_bits`` is its
square case.  ``conflict_matrix_bits_delta`` recomputes only the entries
whose row or column transaction re-executed this round and carries
``old`` elsewhere — the full rung of every round
(``ops.conflict_matrix_delta``).

Each wrapper takes CPU tensors to its plain version in
:mod:`repro_torch.kernels.ref` and CUDA tensors to its kernel, or
raises; there is no fallback from one to the other.  The carried table
is bool here (the reference pads it to int32 for the TPU and returns
``!= 0``); the kernels read and write it as one byte per entry.

The kernels cut the W axis into slices and the table into tiles, and
:func:`launch_plan` chooses both from the shape, so that every shape
fills the card; the slices of one tile meet in an exact OR through a
small scratch kept for each stream (:func:`_scratch`), which each launch
zeroes on its stream before it runs.  The delta kernel reads its cut of
W for the call's live count from a table made here (:func:`delta_cuts`).

``LAUNCHES`` counts kernel launches per wrapper (never plain-version
calls), so a run can show that it went through the kernels; ``SHAPES``
counts the same launches by ``(wrapper, M, N, W)``.
"""

from __future__ import annotations

import dataclasses
import functools
from collections import Counter

import torch

from repro_torch.kernels import _build, ref

LAUNCHES = {"conflict_matrix_bits_pair": 0, "conflict_matrix_bits_delta": 0}
SHAPES: Counter = Counter()


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    SHAPES.clear()


def _count(name: str, m: int, n: int, w: int) -> None:
    LAUNCHES[name] += 1
    SHAPES[(name, m, n, w)] += 1


SMS = 132               # the H100's streaming multiprocessors
BLOCKS = 2 * SMS        # block slots: an SM holds two blocks of any tile
CHUNK = 32              # words of W per pipeline stage (csrc: CW)
SCRATCH_STRIDE = 512    # mask words per tile in the scratch combine (csrc)
# the tile menu of csrc/conflict.cu, block rows x block columns: the
# tiles the engines' strips take (8 x 8, (C, 1024) and (1024, C) for C in
# 16, 64, 256, and K x K)
TILES = ((16, 8), (16, 128), (128, 16), (64, 128), (128, 64), (128, 128))


@dataclasses.dataclass(frozen=True)
class Plan:
    """A launch of the conflict kernel over an (M, N) table and W words:
    ``tiles_m`` x ``tiles_n`` tiles of ``bm`` x ``bn`` entries and W cut
    into ``slices`` slices of ``slice_words`` words (the last one
    shorter); more than one slice a tile meet through the scratch."""

    bm: int
    bn: int
    tiles_m: int
    tiles_n: int
    slices: int
    slice_words: int

    def word_range(self, s: int, w: int) -> tuple[int, int]:
        """Words ``[lo, hi)`` of slice ``s``."""
        lo = s * self.slice_words
        return lo, min(w, lo + self.slice_words)

    def scratch_words(self, jobs: int = 1) -> int:
        """64-bit words of scratch the slices' combine needs."""
        if self.slices == 1:
            return 0
        return jobs * self.tiles_m * self.tiles_n * (SCRATCH_STRIDE + 1)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def tile_for(m: int, n: int) -> tuple[int, int]:
    """The tile of the menu with the fewest entries (the first of two as
    large) that holds M rows and N columns, at most 128 x 128."""
    m, n = min(m, 128), min(n, 128)
    return min((t for t in TILES if t[0] >= m and t[1] >= n),
               key=lambda t: t[0] * t[1])


def _slices(chunks: int, tiles: int) -> tuple[int, int]:
    """(slices, chunks a slice): the most slices whose blocks fit the
    ``BLOCKS`` slots in one wave (one more slice a tile would leave a
    second wave of a few blocks, each as long as the first), each a whole
    number of stages, and no slice empty."""
    want = max(1, min(chunks, BLOCKS // tiles))
    per = max(1, _cdiv(chunks, want))
    return max(1, _cdiv(chunks, per)), per


@functools.lru_cache(maxsize=256)
def launch_plan(m: int, n: int, w: int) -> Plan:
    """The pair kernel's launch for an (M, N) table over W words: the
    tile of :func:`tile_for`, then W cut by :func:`_slices`."""
    bm, bn = tile_for(m, n)
    tiles_m, tiles_n = _cdiv(m, bm), _cdiv(n, bn)
    slices, per = _slices(_cdiv(w, CHUNK), tiles_m * tiles_n)
    return Plan(bm, bn, tiles_m, tiles_n, slices, per * CHUNK)


@functools.lru_cache(maxsize=64)
def delta_cuts(k: int, w: int) -> tuple[tuple[int, int], ...]:
    """(slices, slice_words) of a delta call over K x K entries and W
    words for each live count 0 .. K, the table the kernel reads by its
    device-side count: the two strips' busy tiles (live rows x K
    columns, settled rows x live columns, tiled as :func:`delta_plan`)
    cut W by :func:`_slices`; with no row live, no tile is busy and W is
    one slice."""
    bm, bn = tile_for(k, k)
    chunks = _cdiv(w, CHUNK)
    cuts = []
    for n_live in range(k + 1):
        busy = (_cdiv(n_live, bm) * _cdiv(k, bn)
                + _cdiv(k - n_live, bm) * _cdiv(n_live, bn))
        slices, per = _slices(chunks, busy) if busy else (1, max(chunks, 1))
        cuts.append((slices, per * CHUNK))
    return tuple(cuts)


@functools.lru_cache(maxsize=64)
def delta_plan(k: int, w: int) -> Plan:
    """The delta kernel's launch for a K x K table over W words: each
    strip tiled as the whole table, the grid holding the most slices of
    :func:`delta_cuts` (the kernel returns from the slices its live count
    does not need)."""
    bm, bn = tile_for(k, k)
    most = max(slices for slices, _ in delta_cuts(k, w))
    return Plan(bm, bn, _cdiv(k, bm), _cdiv(k, bn), most, 0)


# per (device, stream): launches on one stream use these one after
# another, and a launch on another stream has its own
_SCRATCH: dict[tuple[torch.device, int, torch.dtype], torch.Tensor] = {}
_CUTS: dict[tuple[torch.device, int, int, int], torch.Tensor] = {}


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _scratch(device: torch.device, n: int,
             dtype: torch.dtype = torch.int64) -> torch.Tensor:
    """At least ``n`` elements of scratch of ``dtype`` for the current
    stream of ``device``: the int64 one the slices' combine (zeroed by
    each launch), the int32 one the delta's row lists (rewritten by each
    launch)."""
    key = (device, _stream(device), dtype)
    buf = _SCRATCH.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.empty(max(n, 1), dtype=dtype, device=device)
        _SCRATCH[key] = buf
    return buf


def _device_cuts(device: torch.device, k: int, w: int) -> torch.Tensor:
    """:func:`delta_cuts` as (K + 1, 2) int32 on the card, copied once a
    shape and stream from pinned memory, ordered before the launch on
    that stream without the host waiting for it."""
    key = (device, _stream(device), k, w)
    cuts = _CUTS.get(key)
    if cuts is None:
        host = torch.tensor(delta_cuts(k, w), dtype=torch.int32)
        cuts = host.pin_memory().to(device, non_blocking=True)
        _CUTS[key] = cuts
    return cuts


def _check_bits(*tensors: torch.Tensor) -> None:
    w = tensors[0].shape[-1]
    dev = tensors[0].device
    for t in tensors:
        if t.dim() != 2 or t.dtype != torch.int32 or t.shape[1] != w:
            raise ValueError(
                f"packed bitsets must be 2-D int32 with one word count, got "
                f"{t.dtype} {tuple(t.shape)}")
        if t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}")


def conflict_matrix_bits_pair(foot_bits: torch.Tensor,
                              write_bits: torch.Tensor) -> torch.Tensor:
    """(M, N) bool, out[i, j] = any_w(foot_bits[i, w] & write_bits[j, w]),
    for foot_bits (M, W) and write_bits (N, W) int32 over different row
    sets.  Any M, N and W; nothing is padded."""
    _check_bits(foot_bits, write_bits)
    if not _build.on_card(foot_bits, "conflict"):
        return ref.conflict_matrix_bits_pair_ref(foot_bits, write_bits)
    m, w = foot_bits.shape
    n = write_bits.shape[0]
    foot_bits = foot_bits.contiguous()
    write_bits = write_bits.contiguous()
    out = torch.empty((m, n), dtype=torch.bool, device=foot_bits.device)
    if m == 0 or n == 0:
        return out
    plan = launch_plan(m, n, w)
    scratch = _scratch(out.device, plan.scratch_words())
    _build.launch("conflict", "pot_conflict_pair", foot_bits.device,
                  foot_bits.data_ptr(), write_bits.data_ptr(), out.data_ptr(),
                  scratch.data_ptr(), m, n, w, plan.bm, plan.bn, plan.slices,
                  plan.slice_words)
    _count("conflict_matrix_bits_pair", m, n, w)
    return out


def conflict_matrix_bits(foot_bits: torch.Tensor,
                         write_bits: torch.Tensor) -> torch.Tensor:
    """(K, K) bool — the square case of :func:`conflict_matrix_bits_pair`
    (row i and column j refer to the same transaction ordering)."""
    return conflict_matrix_bits_pair(foot_bits, write_bits)


def conflict_matrix_bits_delta(foot_bits: torch.Tensor,
                               write_bits: torch.Tensor, old: torch.Tensor,
                               live: torch.Tensor) -> torch.Tensor:
    """Incremental (K, K) bool table: entry (i, j) is recomputed where
    ``live[i] | live[j]`` and carried from ``old`` elsewhere.

    ``foot_bits`` / ``write_bits`` (K, W) int32 must already hold the
    current round's packed sets; ``old`` (K, K) and ``live`` (K,) are
    bool."""
    _check_bits(foot_bits, write_bits)
    k, w = foot_bits.shape
    if write_bits.shape[0] != k or old.shape != (k, k) or live.shape != (k,):
        raise ValueError(
            f"delta shapes: foot {tuple(foot_bits.shape)}, write "
            f"{tuple(write_bits.shape)}, old {tuple(old.shape)}, live "
            f"{tuple(live.shape)}")
    if old.dtype != torch.bool or live.dtype != torch.bool:
        raise ValueError("old and live must be bool")
    if old.device != foot_bits.device or live.device != foot_bits.device:
        raise ValueError("old and live must be on the bitsets' device")
    if not _build.on_card(foot_bits, "conflict"):
        return ref.conflict_matrix_bits_delta_ref(foot_bits, write_bits,
                                                  old, live)
    foot_bits = foot_bits.contiguous()
    write_bits = write_bits.contiguous()
    old = old.contiguous()
    live = live.contiguous()
    out = torch.empty((k, k), dtype=torch.bool, device=foot_bits.device)
    if k == 0:
        return out
    plan = delta_plan(k, w)
    lists = _scratch(out.device, 2 * k + 2, torch.int32)
    scratch = _scratch(out.device, plan.scratch_words(jobs=2))
    cuts = _device_cuts(out.device, k, w)
    _build.launch("conflict", "pot_conflict_delta", foot_bits.device,
                  foot_bits.data_ptr(), write_bits.data_ptr(), old.data_ptr(),
                  live.data_ptr(), out.data_ptr(), lists.data_ptr(),
                  scratch.data_ptr(), cuts.data_ptr(), k, w, plan.bm,
                  plan.bn, plan.slices)
    _count("conflict_matrix_bits_delta", k, k, w)
    return out
