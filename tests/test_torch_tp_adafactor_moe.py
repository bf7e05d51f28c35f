"""Adafactor over a rank's shards at a MoE layer: one pot step (2
microbatches) of deepseek-moe-smoke on 8 gloo ranks of a (2, 4) mesh
against the reference's ``make_train_step(optimizer="adafactor")`` on
its own (2, 4) mesh (``tests/_torch_tp.py``), in float32: the expert
leaves cut over both axes (``P(model, data, None)``), their statistics
summed over both; the checks of ``tests/test_torch_tp_adafactor.py``,
and the grouped clip's choice from the whole leaf's shape."""

import functools

import pytest
import torch

torch.set_num_threads(1)

import _torch_tp as tp

from repro_torch.optim import adafactor

ARCH = "deepseek-moe-16b"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return tp.run_both(tmp_path_factory.mktemp("tp_adafactor_moe"),
                       ("train",), archs=(ARCH,), optimizers=("adafactor",))


def test_adafactor_step_matches_reference_mesh_run(runs):
    tp.check_pot_step(runs, ARCH, "adafactor")


def test_adafactor_step_is_the_same_on_every_rank(runs):
    tp.check_same_on_every_rank(runs, ARCH, "adafactor")


def test_grouped_clip_decides_on_the_whole_leaf(monkeypatch):
    """A stacked leaf whose whole shape is above the grouped-clip
    threshold and whose shard is below it is clipped entry by entry,
    as the whole leaf is in the reference; the cut's statistics are
    divided by the shards along each dim."""
    monkeypatch.setattr(adafactor, "_GROUPED_ABOVE", 60)
    shard, cut = (2, 4, 6), (((), 1), ((), 2), ((), 1))
    assert not adafactor._grouped(shard)
    assert adafactor._grouped(adafactor._whole(shard, cut))
    calls = []

    def core(p, g, s, cut):
        calls.append((tuple(p.shape), cut))
        return p, s
    gen = torch.Generator().manual_seed(0)
    p, g = (torch.randn(shard, generator=gen) for _ in range(2))
    s = adafactor._stats(shard, "cpu")
    new, _ = adafactor._leaf(p, g, s, cut, core)
    assert calls == [((4, 6), cut[1:])] * 2
    assert torch.equal(new, p)
    calls.clear()
    adafactor._leaf(p, g, s, adafactor._cut(None, None, 3), core)
    assert calls == [(shard, (((), 1),) * 3)]
    # a mean over dim 1, cut in two, is half the shard's (no group here
    # to sum the other half)
    core = functools.partial(adafactor._leaf_core, beta2=torch.tensor(0.0),
                             lr=1e-2, eps=1e-30, clip_threshold=1.0, wd=0.0)
    _, halved = core(p, g, s, cut)
    _, whole = core(p, g, s)
    assert torch.equal(halved["vr"], whole["vr"])
    assert torch.equal(halved["vc"], whole["vc"] / 2)
