"""Faults planted in the program's step, each of which the comparison
has to catch (``tests/test_potbench_control.py`` and ``control.py``):
each wraps a step ``step(state, batch) -> (state', loss)``."""

from __future__ import annotations

import dataclasses

from potbench.reference.common import flatten, rebuild


def unchanged(step):
    """The step returns the state it was given."""
    def broken(state, batch):
        return state, step(state, batch)[1]
    return broken


def half_batch(step):
    """Half of the batch left out, the mean taken over the rest."""
    def broken(state, batch):
        half = batch["tokens"].shape[0] // 2
        return step(state, {k: v[:half] for k, v in batch.items()})
    return broken


def doubled_leaf(step):
    """The commit of the first layer's first matrix applied twice."""
    def broken(state, batch):
        new, loss = step(state, batch)
        old = [t for _, t in flatten(state.params)]
        now = [t for _, t in flatten(new.params)]
        i = next(i for i, (p, t) in enumerate(flatten(new.params))
                 if p.startswith("layers.0.") and t.dim() >= 2)
        now[i] = old[i] + 2 * (now[i] - old[i])
        return dataclasses.replace(new, params=rebuild(new.params,
                                                       now)), loss
    return broken


FAULTS = {"unchanged": unchanged, "half_batch": half_batch,
          "doubled_leaf": doubled_leaf}
