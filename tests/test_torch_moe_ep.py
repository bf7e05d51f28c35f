"""The port's expert-parallel MoE layer (``models/moe.py``) on 8 gloo
ranks of a (2, 4) ("data", "model") mesh against the reference's
``_moe_shardmap`` on 8 host devices (``tests/_torch_moe_ep.py``), in
float32, deepseek-smoke and arctic-smoke at their capacity factor and at
1.0: each block's routing identical, the output within 1e-5 and the
gradients (x, router, w1, w3, w2; each rank's expert shards against the
reference's cut) within 1e-4 in relative L2.  Then the schedule at one
rank bitwise equal to the dense path through every entry point, and
what it refuses."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import _torch_dist
import _torch_moe_ep as ep


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return ep.run_both(tmp_path_factory.mktemp("moe_ep"),
                       ("layer", "refusals"))


@pytest.mark.parametrize("cf", ep.CFS)
@pytest.mark.parametrize("arch", ep.ARCHS)
def test_layer_matches_reference_schedule(runs, arch, cf):
    ref_result, ranks = runs
    exp = ref_result[(arch, cf)]["layer"]
    for got in ranks:
        d, m = got["coord"]
        layer = got[(arch, cf)]["layer"]
        ep.check_routing(exp["routing"], layer["routing"], (d, m))
        assert ep.rel(layer["y"], exp["y"]) <= ep.LAYER_REL
        # the output and dx whole and equal on every rank
        assert ep.same_bits(layer["y"], ranks[0][(arch, cf)]["layer"]["y"])
        for name, g in layer["grads"].items():
            want = exp["grads"][name]
            if name in ep.EXPERTS:
                want = ep.expert_shard(want, name, d, m)
            else:
                assert ep.same_bits(
                    g, ranks[0][(arch, cf)]["layer"]["grads"][name])
            assert g.shape == want.shape, (name, g.shape, want.shape)
            assert ep.rel(g, want) <= ep.F32_REL, (name, ep.rel(g, want))


def test_capacity_one_drops_in_blocks(runs):
    """At capacity factor 1.0 every case drops tokens in some block, so
    the per-block capacity is what the routing check holds."""
    _, ranks = runs
    for arch in ep.ARCHS:
        kept = [k for got in ranks
                for _, k in got[(arch, 1.0)]["layer"]["routing"]]
        assert not all(k.all() for k in kept), arch


@pytest.mark.parametrize("what, message", [
    ("experts", r"6 experts do not split over the model axis 'model' of 4"),
    ("batch", r"a batch of 3 does not split over the data axes \('data',\)"),
    ("whole", r"w1 of shape \(8, 64, 48\) where the rank's shard is "
              r"\(2, 32, 48\)"),
    ("gradient", r"repeat tokens.*carries no gradient"),
    ("fsdp", r"over the data axes \('data',\) of 2 ranks takes a "
             r"profile with fsdp"),
    ("pure_dp", r"under pure_dp the expert specs .* name the model axis "
                r"'model' twice"),
])
def test_schedule_refuses(runs, what, message):
    import re
    _, ranks = runs
    for got in ranks:
        assert got["refusals"][what] is not None, what
        assert re.search(message, got["refusals"][what]), \
            got["refusals"][what]


def test_one_rank_schedule_is_the_dense_path_bitwise(tmp_path):
    """A world-1 gloo group and a (1, 1) mesh, bf16 at capacity factor
    1.0: the layer's output and gradients, ``lm.forward``,
    ``lm.prefill``, a decode step, a ``Session`` (prefill, 4 steps,
    fingerprint) and a pot train step bitwise equal with and without the
    profile."""
    out = tmp_path / "ok"
    _torch_dist.spawn(_torch_dist.moe_ep_world1_worker, 1, tmp_path / "rdv",
                      list(ep.ARCHS), str(out))
    assert out.exists()
