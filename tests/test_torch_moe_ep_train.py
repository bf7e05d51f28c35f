"""One pot train step (AdamW, 2 microbatches, deepseek-smoke) with the
MoE layers' expert parallelism on 8 gloo ranks of a (2, 4) mesh against
the reference's ``make_train_step`` over its ``_moe_shardmap`` path on
8 host devices (``tests/_torch_moe_ep.py``), in float32, at the smoke
capacity factor and at 1.0: the loss within rtol 1e-5, every new leaf
(each rank's expert shards against the reference's cut) within 1e-4 in
relative L2; each rank's step run twice, the second time with the rank
at data 1, model 0 joining each backward 0.2 s late, bitwise equal; the
leaves other than expert shards bitwise equal on every rank."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import _torch_moe_ep as ep
import _torch_train

from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.tree import leaves

ARCH = "deepseek-moe-16b"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return ep.run_both(tmp_path_factory.mktemp("moe_ep_train"), ("train",),
                       archs=(ARCH,))


def expected(ref_state, cfg, coord) -> list:
    """The reference's new state as rank ``coord``'s leaves: the port's
    tree order, the expert, attention and MLP leaves cut to the rank's
    shards (``lm.local_params``)."""
    exp = convert.train_state_from_numpy(ref_state, cfg, device="cpu")
    trees = [ep.rank_tree(t, cfg, coord)
             for t in (exp.params, exp.opt["m"], exp.opt["v"])]
    return [t.numpy() for t in leaves(
        [trees[0], dict(exp.opt, m=trees[1], v=trees[2])])]


def whole_leaves(ref_state, cfg) -> list:
    """Which of a state's leaves every rank holds whole."""
    exp = convert.train_state_from_numpy(ref_state, cfg, device="cpu")
    return [a.shape == b.shape for a, b in zip(
        leaves([exp.params, exp.opt]), expected(ref_state, cfg, (0, 0)))]


@pytest.mark.parametrize("cf", ep.CFS)
def test_pot_step_matches_reference_schedule(runs, cf):
    ref_result, ranks = runs
    exp = ref_result[(ARCH, cf)]["train"]
    cfg = get_smoke_config(ARCH)
    n = len(leaves(convert.lm_params_from_numpy(exp["state"]["params"], cfg,
                                                "cpu")))
    for got in ranks:
        run, delayed = got[(ARCH, cf)]["train"]
        want = expected(exp["state"], cfg, got["coord"])
        assert run["counters"] == [1, 1]
        np.testing.assert_allclose(run["loss"], exp["loss"],
                                   rtol=ep.F32_LOSS)
        assert len(run["leaves"]) == len(want)
        # a parameter whose gradient has a cancelled column is held
        # through its gradient (m) and statistic (v)
        skip = _torch_train.undetermined(run["leaves"][n:2 * n],
                                         want[n:2 * n])
        assert len(skip) <= cfg.n_layers, skip
        bad = {j: ep.rel(a, b) for j, (a, b) in enumerate(
            zip(run["leaves"], want)) if j not in skip
            and ep.rel(a, b) > ep.F32_REL}
        assert not bad, bad
        # the delayed run bitwise the same
        assert ep.same_bits(run["loss"], delayed["loss"])
        assert all(ep.same_bits(a, b) for a, b in zip(
            run["leaves"], delayed["leaves"], strict=True))


@pytest.mark.parametrize("cf", ep.CFS)
def test_pot_step_is_the_same_on_every_rank(runs, cf):
    ref_result, ranks = runs
    first = ranks[0][(ARCH, cf)]["train"][0]
    whole = whole_leaves(ref_result[(ARCH, cf)]["train"]["state"],
                         get_smoke_config(ARCH))
    for got in ranks[1:]:
        run = got[(ARCH, cf)]["train"][0]
        assert ep.same_bits(run["loss"], first["loss"])
        for a, b, w in zip(run["leaves"], first["leaves"], whole,
                           strict=True):
            if w:           # a shard is the rank's own
                assert ep.same_bits(a, b)
