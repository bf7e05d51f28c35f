"""Quickstart: preordered transactions in 60 seconds, via ``PotSession``
(the port of ``examples/quickstart.py``).

One API for every engine: a session owns the store and the sequencer,
``session.submit(batch, lanes)`` executes a batch, and every engine --
Pot's PCC, the PoGL serial oracle, the DeSTM analog, the OCC baseline --
returns the same ``ExecTrace`` schema.  The demo shows the paper's core
claims on a toy bank-transfer workload:

1. traditional OCC is nondeterministic -- different interleavings
   (modelled as different sequencer orders feeding the ``occ`` engine),
   different final balances;
2. Pot (PCC) is deterministic -- any storage permutation of the batch,
   same outcome, equal to the serial PoGL oracle;
3. record/replay -- capture an OCC run's commit order with
   ``session.replay_log()``, replay it exactly through Pot.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

import numpy as np
import torch

from repro_torch.core import (READ, RMW, WRITE, PotSession, ReplaySequencer,
                              make_batch)
from repro_torch.examples import device_from_args
from repro_torch.tree import tree_map

# 8 accounts, each starting with 100 units
INIT_BALANCES = np.full(8, 100)

# 6 transfer transactions from 3 "threads" (lanes): move 10 from a to b,
# where the destination of the last transfer is data-dependent (indirect)
PROGS = [
    [(RMW, 0, False, -10), (RMW, 1, False, 10)],     # t0: 0 -> 1
    [(RMW, 1, False, -10), (RMW, 2, False, 10)],     # t1: 1 -> 2
    [(RMW, 2, False, -10), (RMW, 3, False, 10)],     # t2: 2 -> 3
    [(RMW, 3, False, -10), (RMW, 4, False, 10)],     # t0: 3 -> 4
    [(RMW, 4, False, -10), (RMW, 5, False, 10)],     # t1: 4 -> 5
    [(READ, 5, False, 0), (WRITE, 1, True, 0)],      # t2: read 5, write
                                                     # to a dep. address
]
LANES = [0, 1, 2, 0, 1, 2]


def main(argv=None) -> None:
    device = device_from_args(__doc__, argv)
    batch = make_batch(PROGS, device=device)

    def session(engine, sequencer=None, n_lanes=1) -> PotSession:
        return PotSession(8, init=INIT_BALANCES, engine=engine,
                          sequencer=sequencer, n_lanes=n_lanes,
                          device=device)

    # --- 1. traditional transactions: outcome depends on the
    # interleaving.  OCC's "order" is whatever arrival interleaving the
    # runtime produced -- each interleaving goes in as a replayed order.
    fps = set()
    for seed in range(6):
        arrival = np.random.default_rng(seed).permutation(6)
        s = session("occ", sequencer=ReplaySequencer(arrival.tolist()))
        s.submit(batch)
        fps.add(s.fingerprint())
    print(f"OCC outcomes across 6 interleavings : {len(fps)} distinct")

    # --- 2. Pot: the sequencer fixes the order BEFORE execution
    pot = session("pcc", n_lanes=3)
    trace = pot.submit(batch, LANES)
    commit_order = pot.replay_log()   # committed txn order (= sequencer's)

    # permuting the *storage order* of the batch must not change the
    # outcome
    fps = set()
    for seed in range(6):
        perm = np.random.default_rng(seed).permutation(6)
        inv = np.argsort(perm)
        rows = torch.from_numpy(perm).to(device)
        batch_p = tree_map(lambda a: a[rows], batch)
        order_p = [int(inv[t]) for t in commit_order]   # same logical order
        s = session("pcc", sequencer=ReplaySequencer(order_p))
        s.submit(batch_p)
        fps.add(s.fingerprint())
    oracle = session("pogl", n_lanes=3)
    oracle.submit(batch, LANES)
    print(f"Pot outcomes across 6 interleavings : {len(fps)} distinct")
    print(f"Pot == serial oracle                : "
          f"{fps == {oracle.fingerprint()}}")
    print(f"Pot engine rounds (parallelism)     : {int(trace.rounds)} "
          f"(vs {batch.n_txns} serial steps)")

    # --- 3. record/replay (paper §2.1): one line each way
    rec = session("occ", sequencer=ReplaySequencer([5, 3, 1, 0, 2, 4]))
    rec.submit(batch)
    rep = session("pcc", sequencer=rec.replay_sequencer())
    rep.submit(batch)
    print(f"record/replay reproduces OCC run    : "
          f"{rep.fingerprint() == rec.fingerprint()}")
    print(f"final balances                      : "
          f"{rep.store.values[:, 0].cpu().tolist()}")


if __name__ == "__main__":
    main()
