"""Crash-safe directory commit, after ``repro.core.checkpoint`` (only
:func:`atomic_dir` and its fsync helpers are ported; the session
snapshots, fault injection and the replica loop are ROADMAP queue 1
item 10).  ``repro_torch.ckpt.checkpoint`` commits every trainer
checkpoint through it."""

from __future__ import annotations

import contextlib
import os
import shutil


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
