"""Crash a replica mid-stream, restore it, and watch it reconverge
bitwise (the paper's replica-fault-tolerance claim, §1, made
executable), the port of ``examples/failover.py``.

Pot's determinism is the whole fault-tolerance story: because the
serialization order is fixed BEFORE execution, a replica's state is a
pure function of (arrival journal, drain schedule).  So recovery needs
no coordination protocol -- restore the latest crash-consistent
snapshot, feed the arrival-journal suffix the snapshot had not seen,
and the restarted replica lands on the SAME store fingerprint, the SAME
commit log, the SAME formed batches as a replica that never crashed.

Three acts:

1. **Replica A** serves the whole journal uninterrupted (in-process),
   snapshotting after every 2nd formed batch.
2. **Replica B** runs as a real subprocess (``python -m
   repro_torch.core.checkpoint``) with a deterministic ``FaultPlan``:
   at formed batch 4, phase "execute", the process SIGKILLs itself --
   no cleanup, no goodbye (rc = -9).
3. **Replica B restarts** (a second subprocess) from B's snapshot
   directory + the shared arrival journal, and its summary payload --
   fingerprint, replay log, per-batch trace digests -- is checked
   bit-identical to A's.

Run:  PYTHONPATH=src python -m repro_torch.examples.failover [--device cpu]
"""

import json
import os
import subprocess
import sys
import tempfile

from repro_torch.core import IngressPool, run_replica, trace_digest
from repro_torch.core import workloads as W
from repro_torch.core.checkpoint import snapshot_ids
from repro_torch.core.ingress import programs_from_batch
from repro_torch.examples import device_from_args

SRC = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
N_OBJECTS, N_LANES = 64, 6


def drive(cfg, tag, workdir):
    """One replica process over the JSON config ``cfg``: (its completed
    process, the path its summary goes to)."""
    cfg_path = os.path.join(workdir, f"{tag}.json")
    out_path = os.path.join(workdir, f"{tag}_out.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.core.checkpoint", cfg_path,
         out_path], env=env, capture_output=True, text=True)
    return r, out_path


def main(argv=None) -> None:
    device = device_from_args(__doc__, argv)
    # -- the shared arrival stream: what replication actually ships -----
    wl = W.counters(n_txns=60, n_objects=N_OBJECTS, n_reads=2, n_writes=2,
                    n_lanes=N_LANES, skew=0.7, seed=3, device="cpu")
    source = IngressPool(capacity=512)
    for i, program in enumerate(programs_from_batch(wl.batch)):
        source.admit(program, lane=i % N_LANES, fee=i % 5)
    journal = source.arrival_journal()

    kw = dict(n_objects=N_OBJECTS, engine="pcc", n_lanes=N_LANES,
              budgets=[7, 11], snapshot_every=2, device=device)
    with tempfile.TemporaryDirectory(prefix="pot_failover_") as workdir:
        print(f"workdir: {workdir}")

        # -- act 1: replica A, uninterrupted ----------------------------
        a = run_replica(journal, directory=os.path.join(workdir, "a"), **kw)
        a_digests = [trace_digest(t) for t in a.session.traces]
        print(f"\nreplica A (uninterrupted): {a.session.batches_formed} "
              f"batches, {a.session.snapshots_taken} snapshots, "
              f"fingerprint 0x{a.session.fingerprint():08x}")

        # -- act 2: replica B takes a SIGKILL at (batch 4, execute) -----
        bdir = os.path.join(workdir, "b")
        victim = dict(kw, journal=journal, directory=bdir,
                      fault={"kill_batch": 4, "kill_phase": "execute"})
        r, out_path = drive(victim, "victim", workdir)
        if r.returncode != -9 or os.path.exists(out_path):
            raise SystemExit(f"the victim was not killed: rc {r.returncode}"
                             f"\n{r.stderr[-2000:]}")
        print(f"\nreplica B: SIGKILLed at (batch 4, 'execute') -- rc "
              f"{r.returncode}, snapshots on disk: {snapshot_ids(bdir)}")

        # -- act 3: replica B restarts from its latest snapshot ---------
        r, out_path = drive(dict(kw, journal=journal, directory=bdir,
                                 resume=True), "recovery", workdir)
        if r.returncode != 0:
            raise SystemExit(f"the recovery failed:\n{r.stderr[-2000:]}")
        with open(out_path) as f:
            out = json.load(f)
    print(f"replica B restarted: restored from snapshot "
          f"{out['restored_from']}, replayed {out['recovery_batches']} "
          f"batches from the journal suffix, fingerprint "
          f"0x{out['fingerprint'] & 0xffffffff:08x}")

    same = (out["fingerprint"] == a.session.fingerprint()
            and out["replay_log"] == a.session.replay_log()
            and out["trace_digests"]
            == a_digests[len(a_digests) - len(out["trace_digests"]):]
            and out["pool_depth"] == 0)
    if not same:
        raise SystemExit("the recovered replica differs from replica A")
    print("\nrecovery == uninterrupted: fingerprint, commit log and "
          "per-batch trace digests all bitwise identical -- determinism "
          "IS the fault-tolerance protocol")


if __name__ == "__main__":
    main()
