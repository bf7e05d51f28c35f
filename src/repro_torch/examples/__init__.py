"""Runnable examples of the port's API, after ``examples/``:
``python -m repro_torch.examples.<name>`` with ``name`` one of
``quickstart``, ``det_replay_debug``, ``serve_batch`` and ``failover``.
Each runs on the card unless given ``--device cpu``."""

from __future__ import annotations

import argparse
import os


def device_from_args(doc: str, argv=None) -> str:
    """The ``--device`` of the command line (``"cuda"`` by default).  On
    the card, torch's deterministic algorithms are switched on, with the
    fixed cuBLAS workspace they need, as the port's launchers do."""
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="where the example runs (default: the card)")
    device = ap.parse_args(argv).device
    if device.startswith("cuda"):
        import torch
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True)
    return device
