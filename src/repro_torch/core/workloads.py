"""STAMP / STMBench7 analog workload generators (paper §4, Fig. 5), copied
from ``repro.core.workloads``: the same seed gives the same programs as
the reference, built into the port's ``TxnBatch`` on ``device``.

Each generator emits a ``TxnBatch`` of bytecode transactions whose
footprint *structure* mirrors the benchmark it is named after — read/write
set sizes, contention profile, and the use of data-dependent (indirect)
addressing — so the engines' structural metrics (rounds, aborts,
wait-rounds, validation work) are driven the way STAMP drives Pot.

All generators are seeded and fully deterministic.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.txn import (NOP, READ, RMW, WRITE, TxnBatch,
                                  make_batch)


@dataclasses.dataclass
class Workload:
    name: str
    batch: TxnBatch
    lanes: np.ndarray      # (K,) lane id per txn
    n_lanes: int
    n_objects: int
    slot: int = 1


def _zipf_addrs(rng, n, n_objects, skew):
    """Contention knob: skew=0 -> uniform; higher -> hotter hot-set."""
    if skew <= 0:
        return rng.integers(0, n_objects, size=n)
    ranks = rng.zipf(1.0 + skew, size=n)
    return np.minimum(ranks - 1, n_objects - 1)


def _assign_lanes(k: int, n_lanes: int) -> np.ndarray:
    return np.arange(k, dtype=np.int64) % n_lanes


def counters(n_txns=64, n_objects=256, n_reads=4, n_writes=4,
             n_lanes=8, skew=0.0, seed=0, device="cuda") -> Workload:
    """§4.1.1 microbenchmark: key-value array of counters.  Knobs map to
    the paper's Fig. 6 axes: access count and read/write ratio."""
    rng = np.random.default_rng(seed)
    progs = []
    for _ in range(n_txns):
        ins = []
        for a in _zipf_addrs(rng, n_reads, n_objects, skew):
            ins.append((READ, int(a), False, 0))
        for a in _zipf_addrs(rng, n_writes, n_objects, skew):
            ins.append((RMW, int(a), False, 1))
        progs.append(ins or [(NOP, 0, False, 0)])
    return Workload("counters", make_batch(progs, device=device),
                    _assign_lanes(n_txns, n_lanes), n_lanes, n_objects)


def vacation_like(n_txns=64, n_objects=1024, n_lanes=8, update_pct=90,
                  seed=0, device="cuda") -> Workload:
    """OLTP reservations: read a handful of 'table rows', update a few.
    ``update_pct`` follows STAMP's -u flag (Vacation- u=98, Vacation+ u=90;
    lower u = more contention in the paper's configs)."""
    rng = np.random.default_rng(seed)
    progs = []
    for _ in range(n_txns):
        ins = []
        hot = rng.random() * 100 < update_pct
        n_r = int(rng.integers(4, 10))
        skew = 0.9 if hot else 0.2
        addrs = _zipf_addrs(rng, n_r, n_objects, skew)
        for a in addrs[:-2]:
            ins.append((READ, int(a), False, 0))
        for a in addrs[-2:]:
            ins.append((RMW, int(a), False, 1))
        progs.append(ins)
    return Workload("vacation", make_batch(progs, device=device),
                    _assign_lanes(n_txns, n_lanes), n_lanes, n_objects)


def kmeans_like(n_txns=64, n_centroids=16, n_objects=128, n_lanes=8,
                seed=0, device="cuda") -> Workload:
    """Iterative clustering: tiny txns all RMW-ing a few hot centroid
    objects — high write-write contention, small footprints."""
    rng = np.random.default_rng(seed)
    progs = []
    for _ in range(n_txns):
        c = int(rng.integers(0, n_centroids))
        progs.append([(RMW, c, False, 1), (RMW, c + n_centroids, False, 1)])
    return Workload("kmeans", make_batch(progs, device=device),
                    _assign_lanes(n_txns, n_lanes), n_lanes, n_objects)


def ssca2_like(n_txns=64, n_objects=4096, n_lanes=8, seed=0,
               device="cuda") -> Workload:
    """Graph kernel: small txns, near-disjoint writes (low contention) —
    the workload where ordered commits cost the most relative overhead."""
    rng = np.random.default_rng(seed)
    progs = []
    for _ in range(n_txns):
        a = int(rng.integers(0, n_objects))
        progs.append([(READ, a, False, 0), (WRITE, (a * 7 + 13) % n_objects,
                                            False, 3)])
    return Workload("ssca2", make_batch(progs, device=device),
                    _assign_lanes(n_txns, n_lanes), n_lanes, n_objects)


def labyrinth_like(n_txns=32, n_objects=512, path_len=24, n_lanes=8,
                   seed=0, device="cuda") -> Workload:
    """Path routing: long transactions that read a candidate path and then
    claim (write) every cell — huge footprints, frequent overlap."""
    rng = np.random.default_rng(seed)
    progs = []
    for _ in range(n_txns):
        start = int(rng.integers(0, n_objects))
        step = int(rng.integers(1, 5))
        ins = []
        for j in range(path_len // 2):
            a = (start + j * step) % n_objects
            ins.append((READ, a, False, 0))
        for j in range(path_len // 2):
            a = (start + j * step) % n_objects
            ins.append((WRITE, a, False, 1))
        progs.append(ins)
    return Workload("labyrinth", make_batch(progs, device=device),
                    _assign_lanes(n_txns, n_lanes), n_lanes, n_objects)


def genome_like(n_txns=64, n_objects=2048, n_lanes=8, seed=0,
                device="cuda") -> Workload:
    """Sequence assembly: dedup inserts (RMW on hashed addresses) plus
    *indirect* chained reads — dynamic read sets via pointer chasing."""
    rng = np.random.default_rng(seed)
    progs = []
    for i in range(n_txns):
        ins = []
        a = int(rng.integers(0, n_objects))
        ins.append((RMW, a, False, 1))                 # hashset insert
        ins.append((READ, int(rng.integers(0, n_objects)), False, 0))
        ins.append((READ, 11, True, 0))                # chase: addr = 11+last
        ins.append((READ, 3, True, 0))                 # chase again
        if i % 3 == 0:
            ins.append((WRITE, 5, True, 2))            # link segment
        progs.append(ins)
    return Workload("genome", make_batch(progs, device=device),
                    _assign_lanes(n_txns, n_lanes), n_lanes, n_objects)


def yada_like(n_txns=48, n_objects=1024, n_lanes=8, seed=0,
              device="cuda") -> Workload:
    """Delaunay refinement: medium cavity re-triangulations with pointer
    chasing and moderate overlap."""
    rng = np.random.default_rng(seed)
    progs = []
    for _ in range(n_txns):
        ins = []
        a = int(rng.integers(0, n_objects))
        ins.append((READ, a, False, 0))
        for _ in range(int(rng.integers(2, 5))):
            ins.append((READ, int(rng.integers(1, 17)), True, 0))
        for _ in range(int(rng.integers(2, 4))):
            ins.append((WRITE, int(rng.integers(1, 17)), True, 1))
        progs.append(ins)
    return Workload("yada", make_batch(progs, device=device),
                    _assign_lanes(n_txns, n_lanes), n_lanes, n_objects)


def intruder_like(n_txns=64, n_objects=1024, n_lanes=8, seed=0,
                  device="cuda") -> Workload:
    """Packet reassembly: queue pops (hot head RMW) + map inserts."""
    rng = np.random.default_rng(seed)
    progs = []
    for _ in range(n_txns):
        ins = [(RMW, 0, False, 1)]  # shared queue head — global hot spot
        for _ in range(int(rng.integers(1, 4))):
            ins.append((RMW, int(rng.integers(16, n_objects)), False, 1))
        progs.append(ins)
    return Workload("intruder", make_batch(progs, device=device),
                    _assign_lanes(n_txns, n_lanes), n_lanes, n_objects)


def bayes_like(n_txns=32, n_objects=512, n_lanes=8, seed=0,
               device="cuda") -> Workload:
    """Structure learning: few very large read sets, small writes."""
    rng = np.random.default_rng(seed)
    progs = []
    for _ in range(n_txns):
        ins = []
        for _ in range(int(rng.integers(8, 16))):
            ins.append((READ, int(rng.integers(0, n_objects)), False, 0))
        ins.append((WRITE, int(rng.integers(0, n_objects)), False, 1))
        progs.append(ins)
    return Workload("bayes", make_batch(progs, device=device),
                    _assign_lanes(n_txns, n_lanes), n_lanes, n_objects)


def stmbench7_like(workload: str = "rw", n_txns=64, n_objects=4096,
                   n_lanes=8, seed=0, device="cuda") -> Workload:
    """STMBench7 (Fig. 5): r / rw / w mixes over a large object graph.
    Short+long traversals (large read sets, pointer chasing) mixed with
    structural modifications (medium write sets)."""
    ratios = {"r": (0.9, 0.1), "rw": (0.6, 0.4), "w": (0.1, 0.9)}[workload]
    rng = np.random.default_rng(seed)
    progs = []
    for _ in range(n_txns):
        ins = []
        if rng.random() < ratios[0]:   # traversal
            a = int(rng.integers(0, n_objects))
            ins.append((READ, a, False, 0))
            for _ in range(int(rng.integers(6, 14))):
                ins.append((READ, int(rng.integers(1, 33)), True, 0))
        else:                          # structural modification
            a = int(rng.integers(0, n_objects))
            ins.append((READ, a, False, 0))
            for _ in range(int(rng.integers(2, 5))):
                ins.append((RMW, int(rng.integers(1, 33)), True, 1))
        progs.append(ins)
    return Workload(f"stmbench7-{workload}",
                    make_batch(progs, device=device),
                    _assign_lanes(n_txns, n_lanes), n_lanes, n_objects)


STAMP = {
    "bayes": bayes_like,
    "genome": genome_like,
    "intruder": intruder_like,
    "kmeans": kmeans_like,
    "labyrinth": labyrinth_like,
    "ssca2": ssca2_like,
    "vacation": vacation_like,
    "yada": yada_like,
}
