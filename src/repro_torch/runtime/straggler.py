"""Straggler mitigation under Pot semantics, the port's own copy of
``repro.runtime.straggler`` (it has no tensor code).

The paper's structure gives stragglers for free: the order-head (fast
transaction) never waits on anyone, and late transactions are speculative
— their work overlaps the wait instead of blocking the commit stream.
This module provides:

- ``simulate_arrivals``: a seeded arrival-delay model (exp-tail) that
  produces arrival permutations for determinism tests — Pot's output must
  be invariant to ALL of them (tests/test_torch_optim.py holds the copy to
  the reference).
- ``commit_deadline_policy``: bounded-staleness policy for the training
  integration: a gradient transaction arriving more than ``max_stale``
  sequence positions late is re-based (recomputed against the current
  version) rather than validated — the PCC abort/retry path, surfaced as
  a runtime knob.
"""

from __future__ import annotations

import numpy as np


def simulate_arrivals(n_txns: int, *, n_stragglers: int = 0,
                      tail_factor: float = 10.0, seed: int = 0) -> np.ndarray:
    """Return an arrival permutation: txn indices in arrival order.
    ``n_stragglers`` transactions get an exp-tail delay."""
    rng = np.random.default_rng(seed)
    delay = rng.exponential(1.0, size=n_txns)
    if n_stragglers:
        worst = rng.choice(n_txns, size=n_stragglers, replace=False)
        delay[worst] *= tail_factor
    return np.argsort(delay, kind="stable")


def commit_deadline_policy(seq_no: int, gv: int, *, max_stale: int = 8):
    """Decide how a late transaction commits.

    Returns "fast" (it is the order head), "validate" (speculative,
    within staleness budget — validate read versions and commit), or
    "rebase" (too stale — recompute against the current store)."""
    lag = seq_no - gv - 1
    if lag <= 0:
        return "fast"
    if lag <= max_stale:
        return "validate"
    return "rebase"
