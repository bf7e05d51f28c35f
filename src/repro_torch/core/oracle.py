"""A plain serial interpreter of the transaction bytecode, in numpy.

The oracle the port's results are held to: it shares no code with the
engines (or with ``txn.run_all``).  It applies each transaction in
sequence order against the running image, with the VM's semantics
written out one instruction at a time: direct or indirect addressing
(``|addr + last_read|`` wrapped to int32, floor-mod the object count),
read-your-writes within a transaction, int32 wrap-around of the
accumulator, and at commit the last deferred write per address, with
the object's version stamped by the transaction's global sequence
position.  Vacant rows (``n_ins == 0``) are skipped and take no
position.
"""

from __future__ import annotations

import numpy as np

NOP, READ, WRITE, RMW = 0, 1, 2, 3


def _wrap32(x: int) -> int:
    return (x + (1 << 31)) % (1 << 32) - (1 << 31)


def serial_execute(values: np.ndarray, versions: np.ndarray, gv: int,
                   batches, seqs) -> tuple[np.ndarray, np.ndarray, int]:
    """Run ``batches`` (each a mapping with ``opcodes``, ``addrs``,
    ``indirect``, ``operands`` and ``n_ins`` as numpy arrays) in the order
    ``seqs`` gives (one array of sequence numbers per batch) against the
    image ``values`` (O, S) / ``versions`` (O,).  Returns the final
    ``(values, versions, gv)``; the inputs are not modified."""
    values = np.array(values, dtype=np.int64)
    versions = np.array(versions, dtype=np.int64)
    n_obj = values.shape[0]
    for b, seq in zip(batches, seqs):
        for t in np.argsort(np.asarray(seq), kind="stable"):
            n = int(b["n_ins"][t])
            if n == 0:
                continue
            gv += 1
            acc = np.zeros(values.shape[1], np.int64)
            last = 0
            buf: dict[int, np.ndarray] = {}   # deferred writes, latest wins
            for j in range(n):
                op = int(b["opcodes"][t, j])
                if op == NOP:
                    continue
                a = int(b["addrs"][t, j])
                if b["indirect"][t, j]:
                    eff = _wrap32(abs(_wrap32(a + last))) % n_obj
                else:
                    eff = a % n_obj
                if op in (READ, RMW):
                    rval = buf[eff] if eff in buf else values[eff]
                    acc = np.array([_wrap32(int(x)) for x in acc + rval])
                    last = int(rval[0])
                if op in (WRITE, RMW):
                    buf[eff] = np.array(
                        [_wrap32(int(x) + int(b["operands"][t, j]))
                         for x in acc])
            for eff, v in buf.items():
                values[eff] = v
                versions[eff] = gv
    return values.astype(np.int32), versions.astype(np.int32), gv
