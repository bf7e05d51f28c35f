"""Serve a small model with batched requests under deterministic commits
(the paper's replica-fault-tolerance use case, §1), the port of
``examples/serve_batch.py``.

Three demos:

1. **Replicated LM serving** -- two replica Sessions receive the same
   requests in DIFFERENT submission interleavings; because slot commits
   are preordered (sequencer over slots, ordered paged commits with
   version stamps), both replicas emit identical token streams and
   identical page-version state.

2. **Ragged transactional streaming** -- every tick hands the engine
   however many transactions arrived.  ``PotSession`` pads each ragged
   batch up to a power-of-two shape bucket with vacant NOP rows (which
   never commit), so the whole stream runs on a handful of step shapes
   with a store bitwise identical to the exact-shape run.

3. **Deterministic ingress** -- clients submit single transactions with
   fees on per-client lanes into an ``IngressPool`` (bounded capacity,
   logical stamps, no wall-clock).  The pool's priority drain FORMS the
   batches, and the drain order is a pure function of pool state -- so
   replicas fed the same arrival journal, each draining under its own
   budget schedule, emit bit-identical stores and commit logs.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_batch [--device cpu]
"""

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import READ, WRITE, IngressPool, PotSession
from repro_torch.core import workloads as W
from repro_torch.examples import device_from_args
from repro_torch.models import lm
from repro_torch.serve.session import Session

REQUESTS = [(0, 7), (1, 23), (2, 5), (3, 99)]   # (slot, first token)


def replicated_serving(device) -> None:
    cfg = get_smoke_config("stablelm_12b")
    params = lm.init_params(torch.Generator(device=device).manual_seed(42),
                            cfg)
    streams = []
    for replica, order in enumerate([REQUESTS, REQUESTS[::-1]]):
        sess = Session(cfg, params, n_slots=4, max_seq=64, device=device)
        for slot, tok in order:          # different arrival interleaving
            sess.add_request(slot, tok)
        toks = sess.generate(12)
        streams.append((toks, sess.fingerprint()))
        print(f"replica {replica}: state fingerprint "
              f"0x{sess.fingerprint():08x}")
        for slot, tok in REQUESTS:
            print(f"  slot {slot} <- {tok}: {toks[slot].tolist()}")
    identical = (np.array_equal(streams[0][0], streams[1][0])
                 and streams[0][1] == streams[1][1])
    print(f"replicas bitwise identical: {identical}")
    if not identical:
        raise SystemExit("the serving replicas diverged")


def ragged_streaming(device) -> None:
    print("\nragged streaming: 16 ticks of 1..48 txns each")
    rng = np.random.default_rng(7)
    ticks = []
    for i in range(16):
        k = int(rng.integers(1, 49))             # whatever arrived this tick
        wl = W.counters(n_txns=k, n_objects=256, n_reads=2, n_writes=2,
                        n_lanes=4, skew=0.6, seed=50 + i, device=device)
        ticks.append((wl.batch, wl.lanes.tolist()))
    shapes = sorted({(b.n_txns, b.max_ins) for b, _ in ticks})
    sessions = {}
    for mode, bucket in (("bucketed", True), ("exact-shape", False)):
        sess = PotSession(256, engine="pcc", n_lanes=4, bucket=bucket,
                          device=device)
        for batch, lanes in ticks:
            sess.submit(batch, lanes)
        sessions[mode] = sess
        print(f"  {mode:12s}: {sess.compile_count():2d} step shapes for "
              f"{len(shapes)} distinct shapes "
              f"(buckets: {sorted(sess.bucket_counts())})")
    a, b = sessions["bucketed"], sessions["exact-shape"]
    if (a.fingerprint() != b.fingerprint()
            or a.replay_log() != b.replay_log()
            or a.compile_count() >= len(shapes)):
        raise SystemExit("bucketed streaming differs from the exact shapes")
    print("  bucketed store + commit log bitwise identical to exact-shape "
          "run")


def deterministic_ingress(device) -> None:
    print("\ndeterministic ingress: 60 client txns, 6 lanes, "
          "fee/age priority")
    rng = np.random.default_rng(29)
    source = IngressPool(capacity=256)
    for i in range(60):
        # order-sensitive programs: distinct writes to a hot 16-object
        # set -- any drain-order divergence between replicas flips the
        # store
        program = ((READ, int(rng.integers(0, 16)), False, 0),
                   (WRITE, int(rng.integers(0, 16)), False, 1 + i))
        source.admit(program, lane=int(rng.integers(0, 6)),
                     fee=int(rng.integers(0, 9)))
    arrivals = source.arrival_journal()   # what replication ships

    replica_runs = []
    for name, budgets in (("A: one big drain", [60]),
                          ("B: bursty drains ", [9, 21, 5, 25]),
                          ("C: trickle       ", [8] * 8)):
        pool, _ = IngressPool.replay(arrivals)
        sess = PotSession(16, engine="pcc", n_lanes=6, device=device)
        n_batches = 0
        while (fb := pool.drain(
                budgets[min(n_batches, len(budgets) - 1)])) is not None:
            sess._submit_seq(fb.batch, fb.seq, fb.lanes, ladder=fb.ladder)
            n_batches += 1
        # every admitted transaction was formed into a batch: a
        # non-empty pool would mean the replicas compared other prefixes
        if pool.depth:
            raise SystemExit(f"replica {name} left {pool.depth} txns parked")
        replica_runs.append((sess.fingerprint(), sess.replay_log()))
        print(f"  replica {name}: {n_batches} batches, "
              f"fingerprint 0x{sess.fingerprint():08x}")
    if not replica_runs[0] == replica_runs[1] == replica_runs[2]:
        raise SystemExit("the ingress replicas diverged")
    print("  all replicas bitwise identical: same drain order, same store, "
          "same commit log -- batch boundaries don't matter")


def main(argv=None) -> None:
    device = device_from_args(__doc__, argv)
    replicated_serving(device)
    ragged_streaming(device)
    deterministic_ingress(device)


if __name__ == "__main__":
    main()
