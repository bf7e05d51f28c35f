"""The training step's named spans (``repro_torch.runtime.spans``): a
shared no-op while no profiler runs; under ``torch.profiler`` every span
of a pot step, nested as the code nests them; and the same state after
a step with the profiler on as with it off."""

from __future__ import annotations

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_smoke_config
from repro_torch.data.pipeline import DataConfig, batch_at
from repro_torch.models import lm
from repro_torch.runtime.spans import span
from repro_torch.train import init_state, make_train_step
from repro_torch.tree import leaves

COMMON = {"pot.attn", "pot.mlp", "pot.logits", "pot.loss", "pot.grad_sum",
          "pot.commit"}
SPANS = {"stablelm-12b": COMMON,
         "deepseek-moe-16b": COMMON | {"pot.moe", "pot.moe.route",
                                       "pot.moe.dispatch", "pot.moe.experts",
                                       "pot.moe.combine"}}


def _step(arch: str):
    """A pot step of 2 microbatches, a fresh state and a batch."""
    cfg = get_smoke_config(arch)
    state = init_state(lm.init_params(torch.Generator().manual_seed(2), cfg,
                                      dtype=torch.float32))
    step = make_train_step(cfg, mode="pot", n_microbatches=2)
    batch = batch_at(DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=4),
                     1, device="cpu")
    return step, state, batch


def _path(event) -> list[str]:
    """The ``pot.*`` spans over a profiler event, outermost first."""
    names = []
    while event is not None:
        if event.name.startswith("pot."):
            names.append(event.name)
        event = event.cpu_parent
    return names[::-1]


def test_span_is_one_shared_no_op_without_a_profiler():
    assert not torch.autograd._profiler_enabled()
    off = span("pot.attn")
    assert off is span("pot.commit")
    with off as inner, off:
        assert inner is None


@pytest.mark.parametrize("arch", sorted(SPANS))
def test_a_traced_pot_step_records_every_span(arch):
    step, state, batch = _step(arch)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, batch)
    events = [e for e in prof.events() if e.name.startswith("pot.")]
    assert {e.name for e in events} == SPANS[arch]
    # each sub-span of the MoE layer sits inside its pot.moe
    for e in events:
        if e.name.startswith("pot.moe."):
            assert _path(e) == ["pot.moe", e.name]
    # the shared experts are MLPs inside the MoE layer
    mlp_paths = {tuple(_path(e)) for e in events if e.name == "pot.mlp"}
    assert mlp_paths == ({("pot.moe", "pot.mlp")} if arch.startswith(
        "deepseek") else {("pot.mlp",)})
    # the layers' spans sit outside the ordered sums and the commit
    outer = {"pot.grad_sum", "pot.commit"}
    assert all(_path(e)[0] not in outer or e.name in outer for e in events)


@pytest.mark.parametrize("arch", sorted(SPANS))
def test_the_profiler_changes_no_bit_of_the_step(arch):
    step, state, batch = _step(arch)
    off, loss_off = step(state, batch)
    with profile(activities=[ProfilerActivity.CPU]):
        on, loss_on = step(state, batch)
    assert torch.equal(loss_off, loss_on)
    assert all(torch.equal(a, b) for a, b in zip(leaves(off), leaves(on),
                                                 strict=True))
