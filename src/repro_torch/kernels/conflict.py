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

``LAUNCHES`` counts kernel launches per wrapper (never plain-version
calls), so a run can show that it went through the kernels.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ref

LAUNCHES = {"conflict_matrix_bits_pair": 0, "conflict_matrix_bits_delta": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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


def _launch(fn: str, device: torch.device, *args) -> None:
    """Launch ``fn`` on ``device``'s current stream, with ``device`` made
    current so the kernel runs where its tensors live."""
    from repro_torch.kernels import _build
    lib = _build.load("conflict")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, fn)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn} launch failed: cudaError {err}")


def _on_card(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"no conflict kernel for device {t.device}")
    return True


def conflict_matrix_bits_pair(foot_bits: torch.Tensor,
                              write_bits: torch.Tensor) -> torch.Tensor:
    """(M, N) bool, out[i, j] = any_w(foot_bits[i, w] & write_bits[j, w]),
    for foot_bits (M, W) and write_bits (N, W) int32 over different row
    sets.  Any M, N and W; nothing is padded."""
    _check_bits(foot_bits, write_bits)
    if not _on_card(foot_bits):
        return ref.conflict_matrix_bits_pair_ref(foot_bits, write_bits)
    m, w = foot_bits.shape
    n = write_bits.shape[0]
    foot_bits = foot_bits.contiguous()
    write_bits = write_bits.contiguous()
    out = torch.empty((m, n), dtype=torch.bool, device=foot_bits.device)
    if m == 0 or n == 0:
        return out
    _launch("pot_conflict_pair", foot_bits.device, foot_bits.data_ptr(),
            write_bits.data_ptr(), out.data_ptr(), m, n, w)
    LAUNCHES["conflict_matrix_bits_pair"] += 1
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
    if not _on_card(foot_bits):
        return ref.conflict_matrix_bits_delta_ref(foot_bits, write_bits,
                                                  old, live)
    foot_bits = foot_bits.contiguous()
    write_bits = write_bits.contiguous()
    old = old.contiguous()
    live = live.contiguous()
    out = torch.empty((k, k), dtype=torch.bool, device=foot_bits.device)
    if k == 0:
        return out
    _launch("pot_conflict_delta", foot_bits.device, foot_bits.data_ptr(),
            write_bits.data_ptr(), old.data_ptr(), live.data_ptr(),
            out.data_ptr(), k, w)
    LAUNCHES["conflict_matrix_bits_delta"] += 1
    return out
