"""Pot core on PyTorch: preordered transactions for deterministic
execution (the port of ``repro.core``, main path).

A sequencer fixes the serialization order before execution, then the PCC
engine executes each batch deterministically against the store::

    session = PotSession(n_objects=1024, engine="pcc", n_lanes=8,
                         device="cuda")
    traces = session.run_stream(batches, lanes)
    session.fingerprint(), session.replay_log()

Building blocks: ``TStore`` / ``make_store`` / ``fingerprint``,
``TxnBatch`` / ``make_batch`` and the VM (``run_all``, ``run_live``,
``run_live_compact``), the sequencers, ``get_engine`` / ``ExecTrace``.
"""

from repro_torch.core.engine import (ENGINES, MODE_FAST, MODE_PREFIX,
                                     MODE_SPEC, MODE_UNSET, EngineDef,
                                     ExecTrace, get_engine, make_trace)
from repro_torch.core.pcc import pcc_execute
from repro_torch.core.sequencer import (ExplicitSequencer, ReplaySequencer,
                                        RoundRobinSequencer, seq_to_order)
from repro_torch.core.session import PotSession
from repro_torch.core.tstore import (TStore, dense_image, fingerprint,
                                     make_store, store_with)
from repro_torch.core.txn import (NOP, READ, RMW, WRITE, TxnBatch,
                                  TxnResult, make_batch, next_pow2,
                                  pad_batch, run_all, run_live,
                                  run_live_compact, run_txn)

__all__ = [
    "PotSession", "ExecTrace", "EngineDef", "ENGINES", "get_engine",
    "make_trace", "MODE_UNSET", "MODE_FAST", "MODE_PREFIX", "MODE_SPEC",
    "TStore", "make_store", "store_with", "dense_image", "fingerprint",
    "TxnBatch", "TxnResult", "make_batch", "run_all", "run_live",
    "run_live_compact", "run_txn", "pad_batch", "next_pow2",
    "NOP", "READ", "WRITE", "RMW",
    "RoundRobinSequencer", "ReplaySequencer", "ExplicitSequencer",
    "seq_to_order",
    "pcc_execute",
]
