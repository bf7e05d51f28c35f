"""Pot: deterministic transactional execution, on PyTorch and CUDA.

The port of the JAX package ``repro`` (which stays the reference).  This
package imports neither JAX nor anything of ``repro``.  Its entry points
take an explicit ``device`` and run on the card (``"cuda"``) unless the
caller asks for the CPU; on the card, the conflict tables of every round
come from the hand-written Hopper kernels in ``repro_torch.kernels``.
"""

from repro_torch.core import (ENGINES, NOP, READ, RMW, WRITE, ExecTrace,
                              PotSession, ReplaySequencer,
                              RoundRobinSequencer, TStore, TxnBatch,
                              fingerprint, get_engine, make_batch,
                              make_store, pcc_execute)

__all__ = [
    "PotSession", "ExecTrace", "ENGINES", "get_engine", "pcc_execute",
    "TStore", "make_store", "fingerprint", "TxnBatch", "make_batch",
    "NOP", "READ", "WRITE", "RMW",
    "RoundRobinSequencer", "ReplaySequencer",
]
