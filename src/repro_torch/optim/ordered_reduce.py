"""Deterministic ordered gradient reduction, after
``repro.optim.ordered_reduce``: Pot's ordered commits applied to the
data-parallel gradient transaction.

Float addition is not associative: an all-reduce whose internal schedule
varies with timing or topology gives bitwise-different sums, so
replicated trainers diverge, the nondeterminism Pot removes from
transactional programs.  Here the sequencer's order is the rank, and the
reduction follows a FIXED ring schedule: rank i adds its contribution in
ring position order, so the float summation order is a function of the
ranks alone, never of timing.

- ``ordered_ring_reduce``: reduce-scatter and all-gather around the ring
  of a ``torch.distributed`` process group, 2(n-1) point-to-point shifts
  to the next rank (``batch_isend_irecv``), the reference's schedule
  exactly; gloo with CPU tensors, NCCL with one process per card.
- ``ordered_ring_sum``: the same sum in one process, from the ranks'
  contributions stacked along a leading axis (the ring's order held on
  one card, or against the ring itself).
- ``ordered_tree_sum``: a fixed pairwise tree over a stacked leading axis
  (microbatch lanes inside one device).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

# the backend each tensor device takes its point-to-point operations on
_BACKEND_DEVICE = {"gloo": "cpu", "nccl": "cuda"}


def ring_position(group=None) -> tuple[int, int]:
    """(n, i): the ring's size and this process's position on it.  A call
    with no ``group`` and no initialised process group is a ring of one
    (the reference's n == 1); a ``group`` without an initialised process
    group raises."""
    if not dist.is_initialized():
        if group is not None:
            raise RuntimeError("a process group was given but "
                               "torch.distributed is not initialised")
        return 1, 0
    return dist.get_world_size(group), dist.get_rank(group)


def _shift(t: torch.Tensor, nxt: int, prv: int, group) -> torch.Tensor:
    """Send ``t`` to the next rank and return what the previous one sent
    (the reference's ``ppermute`` with ``i -> i + 1``)."""
    out = torch.empty_like(t)
    for req in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, t.contiguous(), nxt, group),
            dist.P2POp(dist.irecv, out, prv, group)]):
        req.wait()
    return out


def ordered_ring_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """Bitwise-deterministic all-reduce (sum) of ``x`` over ``group`` (the
    default group when None): every rank calls it with its own
    contribution and gets the same sum, the float additions of chunk c
    taken in ring order c, c+1, ..., c-1."""
    n, idx = ring_position(group)
    if n == 1:
        return x
    backend = dist.get_backend(group)
    if _BACKEND_DEVICE.get(backend, x.device.type) != x.device.type:
        raise ValueError(f"a {x.device.type} tensor cannot cross the ring "
                         f"on the {backend} backend")
    peer = lambda i: i if group is None else dist.get_global_rank(group, i)
    nxt, prv = peer((idx + 1) % n), peer((idx - 1) % n)

    flat = x.reshape(-1)
    pad = (-flat.numel()) % n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    chunks = flat.reshape(n, -1)

    # reduce-scatter: the partial sum of chunk c starts at rank c and
    # walks the ring, so chunk c is summed in the order c, c+1, ..., c-1
    acc = chunks[idx]
    for s in range(n - 1):
        acc = _shift(acc, nxt, prv, group) + chunks[(idx - 1 - s) % n]
    # rank i now holds the full sum of chunk (i + 1) % n

    # all-gather the reduced chunks around the same ring
    gathered = torch.zeros_like(chunks)
    gathered[(idx + 1) % n] = acc
    cur = acc
    for s in range(n - 1):
        cur = _shift(cur, nxt, prv, group)
        gathered[(idx - s) % n] = cur
    out = gathered.reshape(-1)
    if pad:
        out = out[:-pad]
    return out.reshape(x.shape)


def ordered_ring_sum(stacked: torch.Tensor) -> torch.Tensor:
    """The sum :func:`ordered_ring_reduce` returns on every rank of a ring
    of ``n = stacked.shape[0]``, rank i's contribution ``stacked[i]``,
    computed in one process: chunk c of the flat, zero-padded vector is
    summed left to right in ring order c, c+1, ..., c-1."""
    n = stacked.shape[0]
    flat = stacked.reshape(n, -1)
    pad = (-flat.shape[1]) % n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(n, pad)], dim=1)
    chunks = flat.reshape(n, n, -1)          # [rank, chunk, ...]
    c = torch.arange(n, device=stacked.device)
    acc = chunks[c, c]
    for j in range(1, n):
        acc = acc + chunks[(c + j) % n, c]
    out = acc.reshape(-1)
    if pad:
        out = out[:-pad]
    return out.reshape(stacked.shape[1:])


def ordered_tree_sum(stacked: torch.Tensor) -> torch.Tensor:
    """Fixed-order pairwise-tree sum over axis 0 (lane order = sequence
    order), an odd level padded with zeros: the same additions whatever
    schedule a plain ``sum`` would take."""
    x = stacked
    while x.shape[0] > 1:
        if x.shape[0] % 2:
            x = torch.cat([x, torch.zeros_like(x[:1])])
        x = x[0::2] + x[1::2]
    return x[0]
