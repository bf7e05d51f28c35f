"""Trainer checkpoints with atomic commit and deterministic restart,
after ``repro.ckpt.checkpoint``.

A restarted replica must rejoin the same serialization order, so a
checkpoint stores, beside the parameters and optimizer state, the Pot
commit cursor (``gv``) and, in ``extra``, the data pipeline's step:
restoring reproduces the run bitwise.

Layout, as the reference's: ``<dir>/step_<n>/``
    manifest.json   — tree structure, dtypes, shapes, host count, extra
    shard_<h>.npz   — this host's leaves, ``leaf_<i>`` in tree order
Commit protocol: :func:`repro_torch.core.checkpoint.atomic_dir` — stage
into ``step_<n>.tmp_<host>``, fsync every file and the directories,
rename atomically, fsync the parent — so a crash at any point leaves
either the previous complete checkpoint or a ``*.tmp*`` directory that
``latest_step`` and ``prune`` never list.
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

from repro_torch.core.checkpoint import atomic_dir
from repro_torch.tree import leaves, unflatten


def _treedef(tree) -> str:
    """The tree's structure as text, its leaves marked ``*``."""
    return repr(unflatten(tree, ["*"] * len(leaves(tree))))


def _steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    return [int(d.split("_")[1]) for d in os.listdir(directory)
            if d.startswith("step_") and "tmp" not in d]


def save(directory: str, step: int, state, *, host_id: int = 0,
         n_hosts: int = 1, extra: dict | None = None) -> str:
    """Atomically save the tree ``state`` (tensors on any device) for
    ``step``; returns the checkpoint's directory."""
    arrays = [t.detach().cpu().numpy() for t in leaves(state)]
    final = os.path.join(directory, f"step_{step}")
    with atomic_dir(final, suffix=f".tmp_{host_id}") as tmp:
        np.savez(os.path.join(tmp, f"shard_{host_id}.npz"),
                 **{f"leaf_{i}": a for i, a in enumerate(arrays)})
        manifest = {
            "step": step,
            "n_leaves": len(arrays),
            "treedef": _treedef(state),
            "n_hosts": n_hosts,
            "dtypes": [str(a.dtype) for a in arrays],
            "shapes": [list(a.shape) for a in arrays],
            "extra": extra or {},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
    return final


def latest_step(directory: str) -> int | None:
    """The newest complete checkpoint's step, or None."""
    steps = _steps(directory)
    return max(steps) if steps else None


def restore(directory: str, step: int, like, *, host_id: int = 0):
    """Restore into the structure of ``like`` (a template tree); each leaf
    lands on its template leaf's device.  Returns ``(state, extra)``."""
    path = os.path.join(directory, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    template = leaves(like)
    if manifest["n_leaves"] != len(template):
        raise ValueError(f"checkpoint has {manifest['n_leaves']} leaves, "
                         f"template has {len(template)}")
    with np.load(os.path.join(path, f"shard_{host_id}.npz")) as data:
        out = []
        for i, t in enumerate(template):
            a = data[f"leaf_{i}"]
            if tuple(a.shape) != tuple(t.shape):
                raise ValueError(f"leaf {i}: checkpoint shape {a.shape}, "
                                 f"template {tuple(t.shape)}")
            out.append(torch.from_numpy(a).to(t.device))
    return unflatten(like, out), manifest["extra"]


def prune(directory: str, keep: int = 3) -> None:
    """Retain only the newest ``keep`` checkpoints."""
    for s in sorted(_steps(directory))[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s}"))
