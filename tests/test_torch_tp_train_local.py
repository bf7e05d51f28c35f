"""One pot train step (AdamW, 2 microbatches) with tensor- and
sequence-parallel attention and MLP on 8 gloo ranks of a (2, 4) mesh
against the reference's ``make_train_step`` on its own (2, 4) mesh run
on 8 host devices (``tests/_torch_tp.py``), in float32, gemma3-smoke (the
banded local ring): the loss within rtol 1e-5, every new leaf
(each rank's shards against the reference's cut by the specs) within
1e-4 in relative L2 and of the shape its spec gives; each rank's step
run twice, the second time with the rank at data 1, model 0 joining each
backward 0.2 s late, bitwise equal; the leaves every rank holds whole
bitwise equal on every rank."""

import pytest
import torch

torch.set_num_threads(1)

import _torch_tp as tp

ARCHS = ("gemma3-27b",)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return tp.run_both(tmp_path_factory.mktemp("tp_train_local"), ("train",),
                       archs=ARCHS)


@pytest.mark.parametrize("arch", ARCHS)
def test_pot_step_matches_reference_mesh_run(runs, arch):
    tp.check_pot_step(runs, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_pot_step_is_the_same_on_every_rank(runs, arch):
    tp.check_same_on_every_rank(runs, arch)
