"""Deterministic data pipeline, after ``repro.data.pipeline`` (a copy:
the same numpy draws, so the same tokens bit for bit).

Replica determinism starts at the input: every batch is a pure function
of (seed, step, host), with no queue timing and no host races.  The
stream is a seeded synthetic token source (a Zipf-like unigram draw with
local bigram structure, so that losses fall) sharded by host; a restart
at step k reproduces batch k exactly (a checkpoint stores only the step
counter)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0


def _fold(seed, *xs) -> np.random.Generator:
    mask = (1 << 64) - 1
    s = int(seed) & mask
    for x in xs:
        s = (s * 6364136223846793005 + int(x)
             + 1442695040888963407) & mask
    return np.random.default_rng(s)


def batch_at(cfg: DataConfig, step: int, device="cuda") -> dict:
    """Batch for ``step`` on this host: {tokens (b, S), labels (b, S)},
    int32 tensors on ``device``."""
    if cfg.global_batch % cfg.n_hosts:
        raise ValueError(f"global batch {cfg.global_batch} does not split "
                         f"over {cfg.n_hosts} hosts")
    b = cfg.global_batch // cfg.n_hosts
    rng = _fold(cfg.seed, step, cfg.host_id)
    # unigram zipf base
    ranks = rng.zipf(1.3, size=(b, cfg.seq_len))
    tokens = np.minimum(ranks - 1, cfg.vocab - 1).astype(np.int32)
    # inject learnable bigram structure: even positions predict +1
    tokens[:, 1::2] = (tokens[:, 0::2] + 1) % cfg.vocab
    labels = np.concatenate(
        [tokens[:, 1:], np.full((b, 1), -1, np.int32)], axis=1)
    return {"tokens": torch.from_numpy(tokens).to(device),
            "labels": torch.from_numpy(labels).to(device)}


def stream(cfg: DataConfig, start_step: int = 0, device="cuda"):
    step = start_step
    while True:
        yield step, batch_at(cfg, step, device)
        step += 1
