"""One pot train step (AdamW, 2 microbatches) with tensor- and
sequence-parallel attention and MLP on 8 gloo ranks of a (2, 4) mesh
against the reference's ``make_train_step`` on its own (2, 4) mesh run
on 8 host devices (``tests/_torch_tp.py``), in float32, stablelm-smoke and
qwen-smoke: the loss within rtol 1e-5, every new leaf
(each rank's shards against the reference's cut by the specs) within
1e-4 in relative L2 and of the shape its spec gives; each rank's step
run twice, the second time with the rank at data 1, model 0 joining each
backward 0.2 s late, bitwise equal; the leaves every rank holds whole
bitwise equal on every rank."""

import pytest
import torch

torch.set_num_threads(1)

import _torch_tp as tp

from repro_torch.configs import get_smoke_config
from repro_torch.models import lm
from repro_torch.runtime.shardings import local_shape

ARCHS = ("stablelm-12b", "qwen15-32b")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return tp.run_both(tmp_path_factory.mktemp("tp_train"), ("train",),
                       archs=ARCHS)


@pytest.mark.parametrize("arch", ARCHS)
def test_pot_step_matches_reference_mesh_run(runs, arch):
    tp.check_pot_step(runs, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_pot_step_is_the_same_on_every_rank(runs, arch):
    tp.check_same_on_every_rank(runs, arch)


@pytest.mark.parametrize("coord", [(0, 0), (1, 3)])
@pytest.mark.parametrize("arch", tp.ARCHS)
def test_rank_leaves_have_the_shapes_of_their_specs(arch, coord):
    """``lm.local_params`` cuts every attention and MLP weight to the
    block its spec gives the rank: columns of w_in and rows of w_out
    over the model axis, FSDP over the data axis, biases over the model
    axis."""
    cfg = get_smoke_config(arch)
    prof = tp.profile(coord)
    params = lm.init_params(None, cfg, dtype=torch.float32, device="meta")
    cut = lm.local_params(params, cfg, prof)
    sizes = {"data": tp.DATA, "model": tp.MODEL}
    n = 0
    for whole, mine, spec in zip(params["layers"], cut["layers"],
                                 lm.param_specs(cfg, prof)["layers"]):
        for sub in ("attn", "mlp"):
            for name, t in whole.get(sub, {}).items():
                assert tuple(mine[sub][name].shape) == local_shape(
                    tuple(t.shape), spec[sub][name], sizes), (sub, name)
                assert mine[sub][name].shape != t.shape
                n += 1
    assert n >= 7 * cfg.n_layers
