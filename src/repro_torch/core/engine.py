"""Engine schema: one trace type, one registry (after
``repro.core.engine``).

Every engine has the signature

    raw(store, batch, seq, lanes, n_lanes) -> (TStore, ExecTrace)

where ``seq`` holds the sequencer's distinct 1-based sequence numbers.
``get_engine("pcc")`` (``"pot"`` is an alias) is the one engine ported
so far.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Callable

import numpy as np
import torch

from repro_torch.core.tstore import TStore
from repro_torch.core.txn import TxnBatch

# Transaction modes (paper §2.2.3), shared by every engine's trace.
MODE_UNSET, MODE_SPEC, MODE_PREFIX, MODE_FAST = 0, 1, 2, 3


@dataclasses.dataclass
class ExecTrace:
    """Per-execution trace, field for field the reference's ExecTrace.

    Per-transaction arrays are indexed by txn index (storage order).
    Fields an engine does not track keep their :func:`make_trace`
    defaults.  Every field is an int32 tensor."""

    commit_round: torch.Tensor  # (K,) engine round of commit
    commit_pos: torch.Tensor    # (K,) commit position (0-based), -1 if none
    first_round: torch.Tensor   # (K,) round of first speculative exec
    retries: torch.Tensor       # (K,) re-executions (aborts)
    mode: torch.Tensor          # (K,) MODE_FAST / MODE_PREFIX / MODE_SPEC
    wait_rounds: torch.Tensor   # (K,) rounds executed-but-waiting
    rounds: torch.Tensor        # ()   total engine rounds
    exec_ops: torch.Tensor      # ()   instruction slots incl. retries
    validation_words: torch.Tensor  # () read-set words validated
    promotions: torch.Tensor    # ()   live promotions (§2.2.3)
    barrier_ops: torch.Tensor   # ()   barrier idle slots (DeSTM)
    wave_trips: torch.Tensor    # ()   wave_commit fixpoint trips (OCC)
    live_txns: torch.Tensor     # ()   Σ rounds re-executed (live) txns
    live_slots: torch.Tensor    # ()   Σ rounds live instruction slots
    walked_slots: torch.Tensor  # ()   Σ rounds executor width × L
    live_per_round: torch.Tensor  # (R,) live count per round, -1 pad
    retry_waves: torch.Tensor     # ()   DeSTM retry waves
    waves_per_round: torch.Tensor  # (R,) retry waves per round, -1 pad
    spec_executed: torch.Tensor    # ()   cross-batch speculation
    spec_invalidated: torch.Tensor  # ()  observables (0 on the serial
    spec_rounds: torch.Tensor       # ()  path)

    @property
    def n_txns(self) -> int:
        return self.commit_round.shape[0]

    def live_counts(self) -> np.ndarray:
        """Per-round live transaction counts, trimmed to the rounds run."""
        lpr = self.live_per_round.cpu().numpy()
        return lpr[:int(self.rounds)] if lpr.size else lpr

    def wave_counts(self) -> np.ndarray:
        """Per-round retry-wave counts, trimmed to the rounds run (empty
        for engines that do not record them)."""
        wpr = self.waves_per_round.cpu().numpy()
        return wpr[:int(self.rounds)] if wpr.size else wpr


TRACE_FIELDS = tuple(f.name for f in dataclasses.fields(ExecTrace))


def make_trace(k: int, *, device="cuda", **overrides) -> ExecTrace:
    """An ExecTrace with every field defaulted; engines override what
    they track."""
    i32 = torch.int32
    full = lambda shape, v: torch.full(shape, v, dtype=i32, device=device)
    fields = dict(
        commit_round=full((k,), -1), commit_pos=full((k,), -1),
        first_round=full((k,), 0), retries=full((k,), 0),
        mode=full((k,), 0), wait_rounds=full((k,), 0),
        live_per_round=full((0,), 0), waves_per_round=full((0,), 0))
    for name in TRACE_FIELDS:
        fields.setdefault(name, full((), 0))
    fields.update(overrides)
    return ExecTrace(**fields)


def rank_from_order(order: torch.Tensor) -> torch.Tensor:
    """Inverse permutation: rank[order[p]] = p (int64)."""
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.shape[0], device=order.device,
                               dtype=order.dtype)
    return rank


def seq_rank(seq: torch.Tensor) -> torch.Tensor:
    """(K,) sequence numbers -> (K,) 0-based rank in the serialization
    order."""
    return rank_from_order(torch.argsort(seq, stable=True))


@dataclasses.dataclass(frozen=True)
class EngineDef:
    """A registered engine: a uniform-signature function
    ``raw(store, batch, seq, lanes, n_lanes)``."""

    name: str
    raw: Callable[..., tuple[TStore, "ExecTrace"]]
    doc: str = ""

    def execute(self, store: TStore, batch: TxnBatch, seq, *,
                lanes=None, n_lanes: int = 1) -> tuple[TStore, ExecTrace]:
        dev = store.device
        if lanes is None:
            lanes = torch.zeros((batch.n_txns,), dtype=torch.int32)
        return self.raw(store, batch.to(dev),
                        torch.as_tensor(seq).to(dev, torch.int32),
                        torch.as_tensor(lanes).to(dev, torch.int32), n_lanes)


ENGINES: dict[str, EngineDef] = {}

_ALIASES = {"pot": "pcc"}
# module that registers each engine (imported on first lookup)
_ENGINE_MODULES = {"pcc": "repro_torch.core.pcc"}
# the reference's other engines, not ported yet
_NOT_PORTED = ("pogl", "destm", "occ")


def register_engine(engine: EngineDef) -> EngineDef:
    ENGINES[engine.name] = engine
    return engine


def get_engine(name: str) -> EngineDef:
    """Look up an engine by name ("pot" is an alias for "pcc")."""
    key = _ALIASES.get(name, name)
    if key in _NOT_PORTED:
        raise NotImplementedError(f"engine {name!r} is not ported yet")
    if key not in ENGINES and key in _ENGINE_MODULES:
        importlib.import_module(_ENGINE_MODULES[key])
    if key not in ENGINES:
        known = sorted(set(ENGINES) | set(_ALIASES))
        raise KeyError(f"unknown engine {name!r}; known engines: {known}")
    return ENGINES[key]
