"""Crash-consistent session checkpoints and deterministic replica
failover, after ``repro.core.checkpoint``.

One deterministic serialization order is what makes fault tolerance
cheap: a replica that crashes anywhere in the stream rejoins bit for
bit, because everything it lost is a function of (last snapshot, the
shared arrival journal's suffix).

- **Session snapshots** (:func:`save_snapshot` / :func:`restore_session`,
  surfaced as ``PotSession.snapshot`` / ``PotSession.restore``): the
  whole resumable state of a ``PotSession`` — the committed store image
  (``store.npz``, or one ``shard_{i}.npz`` per shard, so a snapshot taken
  at S shards restores into any S'), ``gv``, the sequencer cursor, the
  submit and formed-batch counters, bucket bookkeeping, the replay log,
  the elastic lane manager's state, and the ingress pool's journal
  (whose non-drain prefix is the cursor into the shared arrival
  journal).  The speculation window is flushed into the snapshot, never
  persisted.  The format is the reference's: ``snap_%08d`` directories,
  a ``manifest.json`` with per-file sha256 and a chained digest,
  ``SNAP_FORMAT = 1``; a snapshot written by either package restores
  into the other.  Store images leave the card as int32 numpy arrays in
  the reference's shapes.

- **Atomic commit** (:func:`atomic_dir`): write into ``<final>.tmp``,
  fsync every file and the directory, then rename; a crash at any point
  leaves the previous snapshots or a ``.tmp`` directory that restore
  never reads.  ``repro_torch.ckpt.checkpoint`` (the trainer's
  checkpoints) commits through it too.

- **Self-verification**: the manifest carries each file's sha256, the
  store fingerprint and a chained digest (``sha256(parent_chain ||
  core)``); :func:`load_snapshot` proves a snapshot complete, intact and
  of one lineage before it serves, and :func:`latest_snapshot` walks
  back to the newest that verifies.  ``np.savez`` stamps zip times, so
  the chain digests of one history differ between writers; stores,
  replay logs and :func:`trace_digest` s do not.

- **Deterministic fault injection** (:class:`FaultPlan`): fault points
  are (formed-batch index, phase) positions in the order, never
  wall-clock or random.  ``action="sigkill"`` delivers a real SIGKILL,
  ``action="raise"`` raises :class:`FaultInjected`; the torn variant
  corrupts the staged snapshot before the rename.

- **The replica loop** (:func:`run_replica`): arrival journal in,
  batches formed under a deterministic budget schedule, a snapshot
  every N batches, faults fired between the steps.  ``resume=True``
  restores from the newest complete snapshot (or cold-starts when none
  exists) and applies the journal's suffix::

      restore(latest snapshot) + drain(arrival journal suffix)
          ==  the uninterrupted stream, bit for bit

  in store fingerprints, ``ExecTrace`` s (``spec_*`` aside) and
  ``replay_log()``, at any snapshot point, budget schedule and
  ``pipeline_depth``.

Run one replica from the command line (``"device"`` in the config,
``"cuda"`` by default)::

    python -m repro_torch.core.checkpoint <config.json> <out.json>
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
import shutil
import signal

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.ingress import EV_DRAIN, IngressPool, JournalError
from repro_torch.core.sequencer import sequencer_from_state, sequencer_state
from repro_torch.core.tstore import TStore, shard_images
from repro_torch.core.tstore import fingerprint as store_fingerprint

SNAP_PREFIX = "snap_"
SNAP_FORMAT = 1
MANIFEST = "manifest.json"

# fault phases, in the order they occur inside one replica-loop turn
PH_ADMIT, PH_DRAIN, PH_EXECUTE, PH_SNAPSHOT = (
    "admit", "drain", "execute", "snapshot")
PHASES = (PH_ADMIT, PH_DRAIN, PH_EXECUTE, PH_SNAPSHOT)


class SnapshotError(RuntimeError):
    """A snapshot is missing, incomplete, corrupted, or off-chain."""


# --------------------------------------------------------------------------
# the atomic tmp/fsync/rename commit protocol (shared with repro_torch.ckpt)
# --------------------------------------------------------------------------
def fsync_dir(path: str) -> None:
    """fsync a directory fd so the rename itself is durable."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def fsync_tree(path: str) -> None:
    """fsync every regular file under ``path``, then the dirs themselves."""
    for root, _dirs, files in os.walk(path):
        for name in files:
            fd = os.open(os.path.join(root, name), os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
        fsync_dir(root)


@contextlib.contextmanager
def atomic_dir(final: str, *, suffix: str = ".tmp"):
    """Atomically materialize the directory ``final``.

    Yields a ``final + suffix`` staging directory to write into.  On
    clean exit: every file is fsynced, an existing ``final`` is
    replaced, the staging dir is renamed into place, and the parent dir
    is fsynced — so a crash at ANY point leaves either the old state or
    a ``*.tmp*`` turd that readers skip, never a half-written ``final``.
    On exception the staging dir is left in place (exactly what a real
    crash leaves behind); it is replaced by the next attempt.
    """
    tmp = final + suffix
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    yield tmp
    fsync_tree(tmp)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    fsync_dir(os.path.dirname(final) or ".")


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _core_digest(manifest: dict) -> str:
    """The chained-digest payload: the fields that pin a snapshot's
    identity (execution outcome + exact file contents)."""
    core = {k: manifest[k] for k in
            ("format", "snapshot_id", "gv", "n_txns", "store_fingerprint",
             "replay_log", "files")}
    return hashlib.sha256(
        json.dumps(core, sort_keys=True).encode()).hexdigest()


def chain_digest(parent: str, manifest: dict) -> str:
    """chain = sha256(parent_chain || core): links snapshot k to k-1, so
    a snapshot directory proves it belongs to one replica lineage."""
    return hashlib.sha256(
        (parent + _core_digest(manifest)).encode()).hexdigest()


def _numpy(a) -> np.ndarray:
    """A trace field or store image on the host (tensors leave their
    device; numpy arrays pass through)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def trace_digest(trace, *, include_spec: bool = False) -> str:
    """Canonical sha256 of an ExecTrace, comparable across processes and
    with the reference's (each field's name, numpy dtype name, shape and
    bytes; every field is int32 in both packages).  ``spec_*`` fields are
    left out by default: they record *when* speculation ran, which
    differs around a restore point."""
    h = hashlib.sha256()
    for f in dataclasses.fields(trace):
        if not include_spec and f.name.startswith("spec_"):
            continue
        arr = _numpy(getattr(trace, f.name))
        h.update(f.name.encode())
        h.update(str(arr.dtype).encode())
        h.update(str(arr.shape).encode())
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


# --------------------------------------------------------------------------
# snapshot save / load / verify
# --------------------------------------------------------------------------
def _snap_path(directory: str, snapshot_id: int) -> str:
    return os.path.join(directory, f"{SNAP_PREFIX}{snapshot_id:08d}")


def snapshot_ids(directory: str) -> list[int]:
    """Ids of the *committed* snapshots in ``directory``, ascending
    (staging ``*.tmp*`` dirs — crash turds — are never listed)."""
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if not name.startswith(SNAP_PREFIX) or "tmp" in name:
            continue
        tail = name[len(SNAP_PREFIX):]
        if tail.isdigit():
            out.append(int(tail))
    return sorted(out)


def _save_npz(tmp: str, name: str, values, versions,
              files: dict[str, str]) -> None:
    path = os.path.join(tmp, name)
    np.savez(path, values=_numpy(values), versions=_numpy(versions))
    files[name] = _sha256_file(path)


def save_snapshot(session, directory: str, *, pool: IngressPool | None = None,
                  _torn_hook=None) -> str:
    """Write one crash-consistent snapshot of ``session`` (and the pool
    feeding it) under ``directory``; returns the committed path.

    The speculation window is flushed first, the replay log is
    materialized, and everything commits through :func:`atomic_dir`.
    ``_torn_hook(tmp)``, when given, runs after all files are staged and
    *before* the atomic rename — the fault-injection seam for torn-write
    tests.

    Under a mesh (one store shard per rank) every rank calls this alike:
    the shards are gathered, rank 0 alone writes the snapshot, and the
    others wait for it and take its chain digest.
    """
    session._spec_flush()
    log = session.replay_log()
    store = session.store
    snap_id = session._next_snapshot_id
    final = _snap_path(directory, snap_id)
    os.makedirs(directory, exist_ok=True)

    sharded = not isinstance(store, TStore)
    images = shard_images(store)
    manifest = {
        "format": SNAP_FORMAT,
        "snapshot_id": snap_id,
        "engine": session.engine.name,
        "n_objects": int(store.n_objects),
        "slot": int(store.slot),
        "shards": len(images),
        "gv": int(store.gv),
        "n_txns": int(session.n_txns),
        "n_batches": len(session.traces),
        "batches_formed": int(session.batches_formed),
        "n_lanes": int(session.n_lanes),
        "bucket": bool(session.bucket),
        "bucket_ladder": session.bucket_ladder,
        "pipeline_depth": int(session.pipeline_depth),
        "replay_log": [int(t) for t in log],
        "bucket_counts": [[int(k), int(l), int(c)] for (k, l), c
                          in sorted(session._bucket_counts.items())],
        "sequencer": sequencer_state(session.sequencer),
        "elastic": (session.elastic.state_dict()
                    if session.elastic is not None else None),
        "pool_journal": (_journal_to_json(pool.journal())
                         if pool is not None else None),
        "snapshots_taken": int(session.snapshots_taken) + 1,
        "restored_from": int(session.restored_from),
        "store_fingerprint": int(store_fingerprint(store)),
        "parent_digest": session._chain_digest,
    }

    mesh = getattr(store, "mesh", None)
    if mesh is not None and mesh.get_local_rank() != 0:
        got = [None]
        dist.broadcast_object_list(got, group=mesh.get_group(),
                                   group_src=0)
        return _committed(session, snap_id, got[0], final)
    try:
        _write_snapshot(final, store, sharded, images, manifest, session,
                        _torn_hook)
    finally:
        if mesh is not None:     # the other ranks wait on this broadcast
            dist.broadcast_object_list([manifest.get("chain_digest")],
                                       group=mesh.get_group(), group_src=0)
    return _committed(session, snap_id, manifest["chain_digest"], final)


def _committed(session, snap_id: int, chain: str | None, final: str) -> str:
    """Advance the session's snapshot cursors past a committed snapshot."""
    if chain is None:
        raise SnapshotError(f"snapshot {final} was not committed")
    session.snapshots_taken += 1
    session._chain_digest = chain
    session._next_snapshot_id = snap_id + 1
    return final


def _write_snapshot(final, store, sharded, images, manifest, session,
                    _torn_hook) -> None:
    with atomic_dir(final) as tmp:
        files: dict[str, str] = {}
        if sharded:
            for i, (vals, vers) in enumerate(images):
                _save_npz(tmp, f"shard_{i}.npz", vals, vers, files)
        else:
            _save_npz(tmp, "store.npz", store.values, store.versions, files)
        manifest["files"] = files
        manifest["chain_digest"] = chain_digest(session._chain_digest,
                                                manifest)
        with open(os.path.join(tmp, MANIFEST), "w") as f:
            json.dump(manifest, f)
        if _torn_hook is not None:
            _torn_hook(tmp)


def load_snapshot(path: str) -> tuple[dict, np.ndarray, np.ndarray]:
    """Load + self-verify one snapshot directory.

    Returns ``(manifest, values, versions)`` with the store already
    reassembled into its dense (O, slot) / (O,) int32 image.  Raises
    :class:`SnapshotError` unless the snapshot proves itself complete:
    per-file sha256 digests match, the reassembled store re-hashes to
    the manifest's fingerprint, and the chain digest recomputes.
    """
    mpath = os.path.join(path, MANIFEST)
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        raise SnapshotError(f"unreadable manifest in {path}: {e}") from e
    if manifest.get("format") != SNAP_FORMAT:
        raise SnapshotError(
            f"unknown snapshot format {manifest.get('format')!r} in {path}")
    for name, digest in manifest["files"].items():
        fpath = os.path.join(path, name)
        if not os.path.exists(fpath):
            raise SnapshotError(f"snapshot {path} is missing {name}")
        actual = _sha256_file(fpath)
        if actual != digest:
            raise SnapshotError(
                f"snapshot {path} file {name} is corrupted: sha256 "
                f"{actual[:12]}… != manifest {digest[:12]}…")
    if chain_digest(manifest["parent_digest"], manifest) \
            != manifest["chain_digest"]:
        raise SnapshotError(f"snapshot {path} chain digest does not verify")

    names = (["store.npz"] if "store.npz" in manifest["files"]
             else [f"shard_{i}.npz" for i in range(manifest["shards"])])
    parts = []
    for name in names:
        with np.load(os.path.join(path, name)) as data:
            parts.append((data["values"], data["versions"]))
    values = np.concatenate([p[0] for p in parts], axis=0)
    versions = np.concatenate([p[1] for p in parts], axis=0)
    o = manifest["n_objects"]
    if values.shape != (o, manifest["slot"]) or versions.shape != (o,):
        raise SnapshotError(
            f"snapshot {path} store image has shape {values.shape}, "
            f"manifest says ({o}, {manifest['slot']})")
    fp = store_fingerprint(_dense_store(values, versions, manifest["gv"],
                                        "cpu"))
    if fp != manifest["store_fingerprint"]:
        raise SnapshotError(
            f"snapshot {path} store image re-hashes to 0x{fp:08x}, "
            f"manifest says 0x{manifest['store_fingerprint']:08x}")
    return manifest, values, versions


def _dense_store(values: np.ndarray, versions: np.ndarray, gv: int,
                 device) -> TStore:
    return TStore(
        values=torch.from_numpy(np.ascontiguousarray(values, np.int32)).to(
            device),
        versions=torch.from_numpy(
            np.ascontiguousarray(versions, np.int32)).to(device),
        gv=torch.tensor(gv, dtype=torch.int32, device=device))


def latest_snapshot(directory: str) -> str | None:
    """Path of the newest snapshot in ``directory`` that *verifies* —
    the latest-complete-snapshot invariant: torn staging dirs are
    invisible (never renamed) and a corrupted committed snapshot is
    skipped in favor of its predecessor.  None when nothing verifies.
    """
    for snap_id in reversed(snapshot_ids(directory)):
        path = _snap_path(directory, snap_id)
        try:
            load_snapshot(path)
        except SnapshotError:
            continue
        return path
    return None


def _journal_to_json(journal) -> list:
    """Journal events as JSON-clean nested lists (tuples round-trip
    through json as lists; IngressPool validation accepts both)."""
    def clean(x):
        if isinstance(x, (list, tuple)):
            return [clean(v) for v in x]
        if isinstance(x, dict):
            return {k: clean(v) for k, v in x.items()}
        if isinstance(x, (np.integer,)):
            return int(x)
        return x
    return [clean(ev) for ev in journal]


def arrival_cursor(journal) -> int:
    """How far into the *shared arrival journal* a pool journal has
    consumed: its non-drain events are exactly the arrival prefix."""
    return sum(1 for ev in journal if ev[0] != EV_DRAIN)


def restore_session(directory: str, *, step: int | None = None,
                    arrival_journal=None, engine: str | None = None,
                    shards: int | None = None, mesh=None,
                    bucket: bool | None = None,
                    bucket_ladder: str | None = None,
                    pipeline_depth: int | None = None,
                    sequencer=None, device="cuda"):
    """Rebuild a ``(PotSession, IngressPool | None)`` from a snapshot.

    Picks the newest *complete* snapshot under ``directory`` (or exactly
    ``snap_<step>`` when ``step`` is given), self-verifies it
    (:func:`load_snapshot`), and rebuilds the whole session state on
    ``device``: the store (resharded into ``shards`` if overridden;
    snapshots are layout-portable), sequencer cursor, replay log,
    submit and formed counters, bucket bookkeeping, elastic lane
    manager, and the ingress pool replayed from its journaled cursor.
    With ``arrival_journal`` (the shared feed), the admissions the
    snapshot had not yet seen are applied to the restored pool, so
    draining the restored replica converges to the uninterrupted stream
    bit for bit.  Overrides default to the snapshot's own values.
    """
    from repro_torch.core.session import PotSession
    from repro_torch.runtime.elastic import ElasticLaneManager

    if step is not None:
        path = _snap_path(directory, step)
    else:
        path = latest_snapshot(directory)
        if path is None:
            raise SnapshotError(
                f"no complete snapshot under {directory!r}")
    manifest, values, versions = load_snapshot(path)

    target_shards = shards if shards is not None else manifest["shards"]
    if sequencer is None:
        sequencer = sequencer_from_state(manifest["sequencer"])
    session = PotSession(
        store=_dense_store(values, versions, manifest["gv"], device),
        engine=engine if engine is not None else manifest["engine"],
        sequencer=sequencer,
        n_lanes=manifest["n_lanes"],
        bucket=bucket if bucket is not None else manifest["bucket"],
        bucket_ladder=(bucket_ladder if bucket_ladder is not None
                       else manifest["bucket_ladder"]),
        shards=target_shards, mesh=mesh,
        pipeline_depth=(pipeline_depth if pipeline_depth is not None
                        else manifest["pipeline_depth"]),
        device=device)

    # resume the session's host-side cursors exactly where the snapshot
    # left them: future batches continue the same global history
    session._n_txns = manifest["n_txns"]
    session._log = list(manifest["replay_log"])
    session._log_batches = 0          # traces list restarts empty …
    session._log_txns = manifest["n_txns"]   # … but ids keep their offset
    session._bucket_counts = {(k, l): c
                              for k, l, c in manifest["bucket_counts"]}
    session._batches_formed = manifest["batches_formed"]
    session.snapshots_taken = manifest["snapshots_taken"]
    session.restored_from = manifest["snapshot_id"]
    session._chain_digest = manifest["chain_digest"]
    session._next_snapshot_id = manifest["snapshot_id"] + 1
    if manifest["elastic"] is not None:
        session.elastic = ElasticLaneManager.from_state(manifest["elastic"])

    pool = None
    if manifest["pool_journal"] is not None:
        pool, _ = IngressPool.replay(manifest["pool_journal"])
        if arrival_journal is not None:
            arrival_journal = list(arrival_journal)
            cursor = arrival_cursor(manifest["pool_journal"])
            if cursor > len(arrival_journal):
                raise JournalError(
                    f"snapshot consumed {cursor} arrival events but the "
                    f"shared journal has only {len(arrival_journal)} — "
                    "journals diverged or the feed was truncated")
            pool.apply(arrival_journal[cursor:])
    return session, pool


# --------------------------------------------------------------------------
# deterministic fault injection
# --------------------------------------------------------------------------
class FaultInjected(RuntimeError):
    """Raised by a ``FaultPlan(action="raise")`` at its fault point."""

    def __init__(self, batch: int, phase: str):
        super().__init__(f"injected fault at batch {batch}, phase {phase!r}")
        self.batch, self.phase = batch, phase


@dataclasses.dataclass
class FaultPlan:
    """A deterministic crash schedule over the replica loop.

    Fault points are positions in the ORDER — (formed-batch index,
    phase) — never wall-clock and never RNG, so a fault plan replays as
    deterministically as the execution it interrupts.  Phases fire
    between the loop's steps: ``admit`` (after the journal is applied,
    before the first drain), ``drain`` (before forming batch k),
    ``execute`` (after forming, before executing batch k), ``snapshot``
    (before the snapshot that follows batch k).  With ``torn=True`` the
    snapshot-phase fault corrupts the staged tmp directory mid-commit
    (truncating the payload before the atomic rename) and THEN dies —
    the torn-write case the latest-complete-snapshot invariant covers.

    ``action``: ``"sigkill"`` (default) delivers a real ``SIGKILL`` to
    the current process — the subprocess harness; ``"raise"`` raises
    :class:`FaultInjected` for in-process tests.
    """

    kill_batch: int | None = None
    kill_phase: str = PH_EXECUTE
    torn: bool = False
    action: str = "sigkill"

    def __post_init__(self):
        if self.kill_phase not in PHASES:
            raise ValueError(f"unknown fault phase {self.kill_phase!r}; "
                             f"pick one of {PHASES}")
        if self.action not in ("sigkill", "raise"):
            raise ValueError(f"unknown fault action {self.action!r}")
        if self.torn and self.kill_phase != PH_SNAPSHOT:
            raise ValueError("torn=True only makes sense at the "
                             "'snapshot' phase (it corrupts the staged "
                             "snapshot mid-commit)")

    def matches(self, batch: int, phase: str) -> bool:
        return self.kill_batch is not None and batch == self.kill_batch \
            and phase == self.kill_phase

    def _die(self, batch: int, phase: str):
        if self.action == "raise":
            raise FaultInjected(batch, phase)
        os.kill(os.getpid(), signal.SIGKILL)   # pragma: no cover

    def fire(self, batch: int, phase: str) -> None:
        """Die iff (batch, phase) is the planned fault point.  The torn
        variant does not fire here — it runs as :meth:`torn_hook` inside
        the snapshot commit instead."""
        if self.matches(batch, phase) and not self.torn:
            self._die(batch, phase)

    def torn_hook(self, tmp: str) -> None:
        """The mid-commit fault: truncate the staged store payload and
        mangle the manifest, then die before the atomic rename — the
        staging dir is left exactly as a torn write would leave it."""
        for name in sorted(os.listdir(tmp)):
            path = os.path.join(tmp, name)
            size = os.path.getsize(path)
            with open(path, "r+b") as f:
                f.truncate(max(size // 2, 1))
        self._die(self.kill_batch if self.kill_batch is not None else -1,
                  PH_SNAPSHOT)


# --------------------------------------------------------------------------
# the replica loop
# --------------------------------------------------------------------------
@dataclasses.dataclass
class ReplicaRun:
    """What one :func:`run_replica` call produced (host-side views)."""

    session: object                     # the PotSession
    pool: IngressPool
    fingerprints: list[int]             # store fingerprint after each
    #                                     executed batch (in record order)

    def summary(self) -> dict:
        """JSON-clean cross-process comparison payload."""
        s = self.session
        return {
            "fingerprint": int(s.fingerprint()),
            "fingerprints": [int(f) for f in self.fingerprints],
            "replay_log": [int(t) for t in s.replay_log()],
            "trace_digests": [trace_digest(t) for t in s.traces],
            "n_batches": len(s.traces),
            "batches_formed": int(s.batches_formed),
            "n_txns": int(s.n_txns),
            "gv": int(s.gv),
            "pool_depth": len(self.pool),
            "restored_from": int(s.restored_from),
            "snapshots_taken": int(s.snapshots_taken),
            "recovery_batches": int(s.recovery_batches),
            "chain_digest": s._chain_digest,
            "elastic": (s.elastic.state_dict()
                        if s.elastic is not None else None),
        }


def run_replica(arrival_journal, *, directory: str, n_objects: int,
                slot: int = 1, engine: str = "pcc", n_lanes: int = 8,
                shards: int = 1, mesh=None, pipeline_depth: int = 0,
                bucket_ladder: str = "pow2", budgets=(16,),
                snapshot_every: int = 2, elastic_events=None,
                fault_plan: FaultPlan | None = None, resume: bool = False,
                record_fingerprints: bool = True,
                device="cuda") -> ReplicaRun:
    """Serve one replica from a shared arrival journal on ``device``,
    snapshotting as it goes — the deterministic failover loop.

    Cold start (``resume=False`` or no complete snapshot yet): replay
    the arrival journal into a fresh pool and serve it with a fresh
    session.  Warm start (``resume=True`` with a complete snapshot):
    :func:`restore_session` + the arrival-journal suffix.  Either way
    the loop is a pure function of (journal, budgets, snapshot_every,
    elastic_events): batch k always drains with ``budgets[k %
    len(budgets)]`` and a snapshot commits after every
    ``snapshot_every``-th formed batch (0 disables) — so a restarted
    replica re-enters the SAME schedule at the position the snapshot
    recorded, and its stream is bit-identical to the uninterrupted run.

    ``fault_plan`` fires between steps (see :class:`FaultPlan`).
    ``record_fingerprints=False`` skips the per-batch host fingerprints
    (each one copies the store to the host).
    """
    from repro_torch.core.session import PotSession
    from repro_torch.runtime.elastic import ElasticLaneManager, ScalingEvent

    plan = fault_plan if fault_plan is not None else FaultPlan()
    budgets = tuple(int(b) for b in budgets)
    if not budgets:
        raise ValueError("budgets must name at least one drain budget")
    arrival_journal = list(arrival_journal)

    session = pool = None
    if resume:
        try:
            session, pool = restore_session(
                directory, arrival_journal=arrival_journal, mesh=mesh,
                device=device)
        except SnapshotError:
            session = pool = None     # nothing committed yet: cold start
    if session is None:
        pool, _ = IngressPool.replay(arrival_journal)
        session = PotSession(n_objects, slot=slot, engine=engine,
                             n_lanes=n_lanes, shards=shards, mesh=mesh,
                             bucket_ladder=bucket_ladder,
                             pipeline_depth=pipeline_depth, device=device)
        if elastic_events:
            session.elastic = ElasticLaneManager(
                n_lanes, [ScalingEvent(*ev) for ev in elastic_events])

    fingerprints: list[int] = []

    def _executed(traces):
        # one fingerprint per loop step that committed work: at D=0 this
        # is exactly the per-batch store sequence; pipelined runs emit
        # one per window drain (positions shift, values stay on the
        # committed-batch boundaries)
        if record_fingerprints and traces:
            fingerprints.append(int(session.fingerprint()))

    plan.fire(session.batches_formed, PH_ADMIT)
    while True:
        b = session.batches_formed
        plan.fire(b, PH_DRAIN)
        fb = pool.drain(budgets[b % len(budgets)])
        if fb is None:
            break
        plan.fire(b, PH_EXECUTE)
        _executed(session._serve_formed(fb, ladder=fb.ladder))
        done = session.batches_formed
        if snapshot_every and done % snapshot_every == 0:
            hook = None
            if plan.matches(done, PH_SNAPSHOT) and plan.torn:
                hook = plan.torn_hook
            else:
                plan.fire(done, PH_SNAPSHOT)
            session.snapshot(directory, pool=pool, _torn_hook=hook)
            if record_fingerprints:
                # the snapshot flushed the speculative window: record
                # the store state the snapshot actually captured
                fingerprints.append(int(session.fingerprint()))
    _executed(session._spec_flush())
    return ReplicaRun(session=session, pool=pool, fingerprints=fingerprints)


# --------------------------------------------------------------------------
# subprocess harness entry point
# --------------------------------------------------------------------------
def _main(argv) -> int:     # pragma: no cover - exercised via subprocess
    """``python -m repro_torch.core.checkpoint <config.json> <out.json>``:
    run one replica per the JSON config, write its summary atomically.

    Config keys = :func:`run_replica` kwargs (``device`` among them,
    ``"cuda"`` by default) plus ``journal`` (the arrival journal as
    nested lists) and optional ``fault`` (a :class:`FaultPlan` field
    dict).  A victim run simply never writes its out file — SIGKILL is
    the point.
    """
    cfg_path, out_path = argv
    with open(cfg_path) as f:
        cfg = json.load(f)
    journal = cfg.pop("journal")
    fault = cfg.pop("fault", None)
    plan = FaultPlan(**fault) if fault else None
    if torch.device(cfg.get("device", "cuda")).type == "cuda":
        torch.use_deterministic_algorithms(True)
    run = run_replica(journal, fault_plan=plan, **cfg)
    payload = run.summary()
    with atomic_dir(out_path + ".d") as tmp:
        with open(os.path.join(tmp, "out.json"), "w") as f:
            json.dump(payload, f)
    shutil.move(os.path.join(out_path + ".d", "out.json"), out_path)
    shutil.rmtree(out_path + ".d", ignore_errors=True)
    return 0


if __name__ == "__main__":   # pragma: no cover
    import sys
    # cuBLAS is deterministic only with a fixed workspace, set before
    # CUDA starts
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    raise SystemExit(_main(sys.argv[1:]))
