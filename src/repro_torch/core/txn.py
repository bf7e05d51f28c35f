"""Transactions with *dynamic* read/write sets, as a bytecode VM on tensors.

The PyTorch port of ``repro.core.txn``: the same tiny bounded-length
bytecode, executed as a host loop over the L instruction slots that is
vectorised over the K transactions of a batch (the reference's
``vmap``-of-``scan`` written out as an explicit K axis).

Opcodes
-------
NOP   — padding.
READ  — acc += M[eff]; logs eff in the read set.
WRITE — M[eff] := acc + operand (deferred); logs eff in the write set.
RMW   — READ then WRITE on the same address (read-modify-write).

Addressing: eff = addr                     (direct)
            eff = |addr + last_read| % O   (indirect — data dependent)

``%`` is floor-mod, as in the reference (torch's ``%`` on tensors is
``torch.remainder``), and ``abs(INT_MIN)`` stays negative before the
mod.  ``acc`` and every address sum wrap as int32.  Reads observe the
transaction's own deferred writes (read-your-writes).

A row's execution is a pure function of its program and the values its
logged reads observed, so executing a subset of rows (``run_live``,
``run_compact``) gives each of them bit-identically the result of a full
``run_all``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

NOP, READ, WRITE, RMW = 0, 1, 2, 3


@dataclasses.dataclass
class TxnBatch:
    """K transactions of up to L instructions each (stacked, masked)."""

    opcodes: torch.Tensor   # (K, L) int32
    addrs: torch.Tensor     # (K, L) int32
    indirect: torch.Tensor  # (K, L) bool
    operands: torch.Tensor  # (K, L) int32
    n_ins: torch.Tensor     # (K,)   int32 — live instruction count

    @property
    def n_txns(self) -> int:
        return self.opcodes.shape[0]

    @property
    def max_ins(self) -> int:
        return self.opcodes.shape[1]

    def to(self, device) -> "TxnBatch":
        return TxnBatch(*(getattr(self, f.name).to(device)
                          for f in dataclasses.fields(self)))

    def rows(self, idx: torch.Tensor) -> "TxnBatch":
        """The batch restricted to rows ``idx`` (a gather)."""
        return TxnBatch(*(getattr(self, f.name)[idx]
                          for f in dataclasses.fields(self)))


@dataclasses.dataclass
class TxnResult:
    """One speculative execution: logged footprint + deferred writes."""

    raddrs: torch.Tensor  # (K, L) int32 — read set (first rn valid)
    rn: torch.Tensor      # (K,)   int32
    waddrs: torch.Tensor  # (K, L) int32 — write set (first wn valid)
    wvals: torch.Tensor   # (K, L, S) int32 — deferred values (write buffer)
    wn: torch.Tensor      # (K,)   int32

    def map(self, fn, *others: "TxnResult") -> "TxnResult":
        """Apply ``fn`` field by field (to this and ``others``' fields)."""
        return TxnResult(*(
            fn(getattr(self, f.name), *(getattr(o, f.name) for o in others))
            for f in dataclasses.fields(self)))


def make_batch(progs: list[list[tuple]], max_ins: int | None = None, *,
               device="cuda") -> TxnBatch:
    """Build a TxnBatch from python programs: each a list of
    (opcode, addr, indirect, operand) tuples.

    A row with ``n_ins == 0`` is a *vacant* row (shape-bucket padding):
    the engines never commit it.  An intentionally empty transaction is a
    single NOP instruction (``[(NOP, 0, False, 0)]``)."""
    k = len(progs)
    length = max_ins or max((len(p) for p in progs), default=1)
    length = max(length, 1)
    op = np.zeros((k, length), np.int32)
    ad = np.zeros((k, length), np.int32)
    ind = np.zeros((k, length), bool)
    opr = np.zeros((k, length), np.int32)
    n = np.zeros((k,), np.int32)
    for i, p in enumerate(progs):
        n[i] = len(p)
        for j, (o, a, b, v) in enumerate(p):
            op[i, j], ad[i, j], ind[i, j], opr[i, j] = o, a, b, v
    return TxnBatch(*(torch.from_numpy(a).to(device)
                      for a in (op, ad, ind, opr, n)))


def run_all(batch: TxnBatch, values: torch.Tensor,
            n_objects: int | None = None) -> TxnResult:
    """Speculatively execute every transaction of the batch against the
    same committed store image ``values`` (O, S) — one engine round of
    read phases.  Pure: ``values`` is never modified.

    ``n_objects`` is the real object count when ``values`` has padding
    rows; effective addresses are reduced mod ``n_objects``.
    """
    n_obj = n_objects if n_objects is not None else values.shape[0]
    k, length = batch.opcodes.shape
    slot = values.shape[1]
    dev = values.device
    i32 = torch.int32
    rows = torch.arange(k, device=dev)
    slots = torch.arange(length, device=dev)
    acc = torch.zeros((k, slot), dtype=i32, device=dev)
    last = torch.zeros((k,), dtype=i32, device=dev)
    rn = torch.zeros((k,), dtype=i32, device=dev)
    wn = torch.zeros((k,), dtype=i32, device=dev)
    raddrs = torch.zeros((k, length), dtype=i32, device=dev)
    waddrs = torch.zeros((k, length), dtype=i32, device=dev)
    wvals = torch.zeros((k, length, slot), dtype=i32, device=dev)
    for t in range(length):
        op = batch.opcodes[:, t]
        active = (t < batch.n_ins) & (op != NOP)
        addr = batch.addrs[:, t]
        eff = torch.where(batch.indirect[:, t],
                          torch.abs(addr + last) % n_obj, addr % n_obj)
        is_read = active & ((op == READ) | (op == RMW))
        is_write = active & ((op == WRITE) | (op == RMW))

        # read-your-writes: latest deferred write to eff, else memory
        match = (waddrs == eff[:, None]) & (slots[None, :] < wn[:, None])
        has_match = match.any(dim=1)
        last_match = torch.where(match, slots[None, :], 0).amax(dim=1)
        rval = torch.where(has_match[:, None], wvals[rows, last_match],
                           values[eff.long()])

        acc = torch.where(is_read[:, None], acc + rval, acc)
        last = torch.where(is_read, rval[:, 0], last)
        # append to the logs: slot rn (wn) of each reading (writing) row,
        # as an elementwise select rather than a scatter
        at_r = is_read[:, None] & (slots[None, :] == rn[:, None])
        raddrs = torch.where(at_r, eff[:, None], raddrs)
        rn = rn + is_read.to(i32)

        wval = acc + batch.operands[:, t, None]
        at_w = is_write[:, None] & (slots[None, :] == wn[:, None])
        waddrs = torch.where(at_w, eff[:, None], waddrs)
        wvals = torch.where(at_w[:, :, None], wval[:, None, :], wvals)
        wn = wn + is_write.to(i32)
    return TxnResult(raddrs=raddrs, rn=rn, waddrs=waddrs, wvals=wvals, wn=wn)


def run_txn(batch_row: TxnBatch, values: torch.Tensor,
            n_objects: int | None = None) -> tuple:
    """Execute ONE transaction (a batch row whose fields have shape
    (L,)) against ``values``; returns ``(raddrs, rn, waddrs, wvals,
    wn)`` for that transaction."""
    one = TxnBatch(*(getattr(batch_row, f.name)[None]
                     for f in dataclasses.fields(batch_row)))
    res = run_all(one, values, n_objects)
    return res.raddrs[0], res.rn[0], res.waddrs[0], res.wvals[0], res.wn[0]


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (>= 1)."""
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def pad_batch(batch: TxnBatch, n_txns: int, max_ins: int) -> TxnBatch:
    """Pad a batch with vacant NOP rows / inert instruction columns up to
    (n_txns, max_ins) — the shape-bucketing primitive.  Padded rows have
    ``n_ins == 0`` (never pending, never committing); padded columns lie
    past every row's ``n_ins``, so real rows execute bit-identically."""
    k, length = batch.opcodes.shape
    pk, pl = n_txns - k, max_ins - length
    if pk < 0 or pl < 0:
        raise ValueError(
            f"pad_batch target ({n_txns}, {max_ins}) smaller than ({k}, "
            f"{length})")
    if pk == 0 and pl == 0:
        return batch
    pad2 = lambda a: torch.nn.functional.pad(a, (0, pl, 0, pk))
    return TxnBatch(
        opcodes=pad2(batch.opcodes), addrs=pad2(batch.addrs),
        indirect=pad2(batch.indirect), operands=pad2(batch.operands),
        n_ins=torch.nn.functional.pad(batch.n_ins, (0, pk)))


def _with_n_ins(batch: TxnBatch, n_ins: torch.Tensor) -> TxnBatch:
    return dataclasses.replace(batch, n_ins=n_ins)


def run_live(batch: TxnBatch, values: torch.Tensor, live: torch.Tensor,
             cache: TxnResult | None = None,
             n_objects: int | None = None) -> TxnResult:
    """Masked re-execution: run only the ``live`` (K,) rows (dead rows run
    with ``n_ins`` masked to 0, so every slot is inert) and keep the
    ``cache`` rows of the settled ones.  With ``cache=None`` dead rows
    come back zeroed.  A live row is bit-identical to the same row of
    ``run_all(batch, values)``."""
    masked = _with_n_ins(batch, torch.where(live, batch.n_ins, 0))
    fresh = run_all(masked, values, n_objects)
    if cache is None:
        return fresh

    def merge(new, old):
        return torch.where(live.reshape(live.shape + (1,) * (new.dim() - 1)),
                           new, old)

    return fresh.map(merge, cache)


# --------------------------------------------------------------------------
# Gather-compacted execution
# --------------------------------------------------------------------------


def gather_live_indices(live: torch.Tensor, width: int
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Pack the live row indices into the first slots of a (width,) index
    vector: ``(idx, valid)`` with every live row's index (ascending) in
    the leading ``live.sum()`` slots.  Requires ``live.sum() <= width``.
    ``idx`` is int64, PyTorch's index type."""
    idx = torch.argsort((~live).to(torch.int32), stable=True)[:width]
    return idx, live[idx]


def run_compact(batch: TxnBatch, values: torch.Tensor, idx: torch.Tensor,
                valid: torch.Tensor,
                n_objects: int | None = None) -> TxnResult:
    """Execute the gathered rows ``batch[idx]`` at compact width
    C = ``idx.shape[0]``; rows with ``~valid`` run inert."""
    cbatch = batch.rows(idx)
    cbatch = _with_n_ins(cbatch, torch.where(valid, cbatch.n_ins, 0))
    return run_all(cbatch, values, n_objects)


def scatter_rows(dst: torch.Tensor, src: torch.Tensor, idx: torch.Tensor,
                 valid: torch.Tensor) -> torch.Tensor:
    """Scatter compact rows back to full width: row ``idx[c]`` of a copy
    of ``dst`` takes row c of ``src`` where ``valid[c]``; other rows are
    untouched.

    Invalid slots of ``idx`` may hold duplicate indices (gather padding),
    so they are masked out before the scatter — never scattered, which
    would make the result depend on which duplicate lands last."""
    out = dst.clone()
    out[idx[valid]] = src[valid]
    return out


def scatter_result(cache: TxnResult, cres: TxnResult, idx: torch.Tensor,
                   valid: torch.Tensor) -> TxnResult:
    """Scatter compact result rows back over ``cache`` (see
    :func:`scatter_rows`)."""
    return cache.map(lambda old, new: scatter_rows(old, new, idx, valid),
                     cres)


def run_live_compact(batch: TxnBatch, values: torch.Tensor,
                     live: torch.Tensor, cache: TxnResult, width: int,
                     n_objects: int | None = None
                     ) -> tuple[TxnResult, TxnResult, torch.Tensor,
                                torch.Tensor]:
    """Compact equivalent of :func:`run_live`: gather the live rows into a
    (width, L) block, execute it, scatter back over ``cache``.  Returns
    ``(merged, cres, idx, valid)``; ``merged`` equals
    ``run_live(batch, values, live, cache)`` whenever
    ``live.sum() <= width``."""
    idx, valid = gather_live_indices(live, width)
    cres = run_compact(batch, values, idx, valid, n_objects)
    merged = scatter_result(cache, cres, idx, valid)
    return merged, cres, idx, valid
