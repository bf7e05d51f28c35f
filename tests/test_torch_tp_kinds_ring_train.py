"""Tensor and sequence parallelism of the other layer kinds, beside
attention and the MLP, on 8 gloo ranks of a (2, 4) mesh against the
reference's own (2, 4) mesh run on 8 host devices
(``tests/_torch_tp.py``), in float32: recurrentgemma-smoke (the RG-LRU
mixers' width over the model axis after ``w_x``, and the local ring's
attention tensor-parallel, its one K/V head's ring cut by rows): one pot
step (AdamW, 2 microbatches), its new leaves within 1e-4
in relative L2 and of the shapes their specs give, the loss within rtol
1e-5, bitwise the same with a rank joining each backward 0.2 s late,
and the leaves every rank holds whole bitwise the same on every rank.
Its forward, prefill and decode step are in
``tests/test_torch_tp_kinds_ring.py``."""

import pytest
import torch

torch.set_num_threads(1)

import _torch_tp as tp

ARCHS = ("recurrentgemma-9b",)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return tp.run_both(tmp_path_factory.mktemp("tp_kinds_ring_train"),
                       ("train",), archs=ARCHS)


@pytest.mark.parametrize("arch", ARCHS)
def test_pot_step_matches_reference_mesh_run(runs, arch):
    tp.check_pot_step(runs, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_pot_step_is_the_same_on_every_rank(runs, arch):
    tp.check_same_on_every_rank(runs, arch)
