"""Concurrency-bug reproduction via deterministic replay (paper §1), the
port of ``examples/det_replay_debug.py``.

An order-violation bug (Fig. 1b): one transaction initializes a
resource, another uses it.  Under traditional OCC the bug manifests only
in SOME interleavings -- the debugging nightmare Pot removes.  We (1)
hunt the bug under OCC sessions, (2) capture the failing commit order
with ``session.replay_log()``, (3) replay it through a Pot session --
the failure now reproduces on EVERY run.  Every step uses the same
``PotSession.submit`` API; only the engine name changes.

Run:  PYTHONPATH=src python -m repro_torch.examples.det_replay_debug [--device cpu]
"""

import numpy as np

from repro_torch.core import (READ, WRITE, PotSession, ReplaySequencer,
                              make_batch)
from repro_torch.examples import device_from_args

# object 0: the resource (0 = uninitialized); object 1: consumer's result
INIT = [(WRITE, 0, False, 42)]          # thread 1: initialize
USE = [(READ, 0, False, 0),             # thread 2: use (assumes init!)
       (WRITE, 1, False, 0)]            # result = resource value


def buggy(session: PotSession) -> bool:
    return int(session.store.values[1, 0]) != 42  # saw uninitialized 0


def main(argv=None) -> None:
    device = device_from_args(__doc__, argv)
    batch = make_batch([INIT, USE], device=device)

    # --- 1. bug hunt under traditional transactions
    seen = []
    for seed in range(8):
        arrival = np.random.default_rng(seed).permutation(2)
        s = PotSession(4, engine="occ",
                       sequencer=ReplaySequencer(arrival.tolist()),
                       device=device)
        s.submit(batch)
        seen.append((seed, buggy(s), s.replay_log()))
    fails = [s for s in seen if s[1]]
    print(f"OCC: bug manifested in {len(fails)}/8 interleavings "
          f"(flaky -- {[s[0] for s in fails]})")

    # --- 2. capture the failing order, 3. replay deterministically
    _, _, commit_log = fails[0]
    repro = []
    for _ in range(5):
        s = PotSession(4, engine="pcc", sequencer=ReplaySequencer(commit_log),
                       device=device)
        s.submit(batch)
        repro.append(buggy(s))
    print(f"Pot replay of failing order: bug reproduces {sum(repro)}/5 runs")
    if not all(repro):
        raise SystemExit("the replayed failing order did not reproduce")

    # and the FIXED order (init before use) never fails:
    ok = []
    for _ in range(5):
        s = PotSession(4, engine="pcc", sequencer=ReplaySequencer([0, 1]),
                       device=device)
        s.submit(batch)
        ok.append(not buggy(s))
    print(f"Pot with init-before-use order:  correct {sum(ok)}/5 runs")
    if not all(ok):
        raise SystemExit("the init-before-use order failed")


if __name__ == "__main__":
    main()
