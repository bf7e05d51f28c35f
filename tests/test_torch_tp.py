"""Tensor and sequence parallelism of the port's attention and MLP
sublayers on 8 gloo ranks of a (2, 4) mesh against the reference's own
(2, 4) mesh run on 8 host devices (``tests/_torch_tp.py``), in float32:
one layer (``lm._sublayer`` on the rank's place: the sequence gathered at each
sublayer's entry, the rank's heads and hidden columns, the partial
outputs reduce-scattered into its sequence block) of stablelm-smoke
(grouped K/V heads gathered whole), qwen-smoke (its own K/V heads, QKV
biases) and gemma3-smoke (the banded local ring), its input whole on
every rank: the output within 1e-5 in relative L2, the input's gradient
and every weight's (each rank's shard against the reference's cut)
within 1e-4, the same on every rank.  The whole model is in
``tests/test_torch_tp_model.py``, the train step in
``tests/test_torch_tp_train.py``."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import _torch_tp as tp
import _torch_train

from repro_torch.configs import get_smoke_config
from repro_torch.models import lm
from repro_torch.runtime.shardings import local_tree
from repro_torch.tree import leaves, tree_map


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return tp.run_both(tmp_path_factory.mktemp("tp_layer"), ("layer",))


def rank_grads(gp, cfg, coord) -> list:
    """The reference's whole gradient of layer 0 as rank ``coord``'s
    leaves (``lm.local_params``'s cut: layer 0's specs)."""
    layer = tree_map(lambda a: torch.from_numpy(np.array(a)), gp)
    prof = tp.profile(coord)
    cut = local_tree(layer, lm.param_specs(cfg, prof)["layers"][0],
                     prof.mesh)
    return [t.numpy() for t in leaves(cut)]


@pytest.mark.parametrize("arch", tp.ARCHS)
def test_layer_matches_reference_mesh_run(runs, arch):
    ref_result, ranks = runs
    exp = ref_result[arch]["layer"]
    cfg = get_smoke_config(arch)
    for got in ranks:
        layer = got[arch]["layer"]
        assert tp.rel(layer["y"], exp["y"]) <= tp.LAYER_REL
        assert tp.rel(layer["gx"], exp["gx"]) <= tp.F32_REL
        want = rank_grads(exp["gp"], cfg, got["coord"])
        assert [a.shape for a in layer["gp"]] == [b.shape for b in want]
        # a gradient that is a cancellation (qwen's key bias in RoPE's
        # slowest dims) is rounding in either package
        skip = _torch_train.undetermined(layer["gp"], want)
        assert len(skip) <= 1, skip
        bad = {j: tp.rel(a, b) for j, (a, b) in enumerate(
            zip(layer["gp"], want)) if j not in skip
            and tp.rel(a, b) > tp.F32_REL}
        assert not bad, bad


@pytest.mark.parametrize("arch", tp.ARCHS)
def test_layer_is_the_same_on_every_rank(runs, arch):
    _, ranks = runs
    first = ranks[0][arch]["layer"]
    for got in ranks[1:]:
        layer = got[arch]["layer"]
        assert tp.same_bits(layer["y"], first["y"])
        assert tp.same_bits(layer["gx"], first["gx"])
