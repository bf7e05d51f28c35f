"""Adafactor over a rank's shards: one pot step (2 microbatches) on 8
gloo ranks of a (2, 4) mesh against the reference's
``make_train_step(optimizer="adafactor")`` on its own (2, 4) mesh run on
8 host devices (``tests/_torch_tp.py``), in float32, on stablelm-smoke
(FSDP and tensor-parallel cuts, the embedding and head by vocab block)
and whisper-smoke (the stacked ``enc_layers`` slot): the loss within
rtol 1e-5, every parameter and statistic leaf (each rank's against the
reference's whole one cut by its spec) within 1e-4 in relative L2; each
rank's step run twice, the second time with the rank at data 1, model 0
joining each backward 0.2 s late, bitwise equal; each leaf and
statistic bitwise equal on every rank that holds the same block of it.
Tied embeddings (no config ties them) on stablelm-smoke, on the rank's
shards and on the dense path, against the reference's mesh run of the
tied config: the logits within 1e-4 and an Adafactor pot step as above.
deepseek-moe-smoke's expert leaves and the grouped clip are in
``tests/test_torch_tp_adafactor_moe.py``."""

import pytest
import torch

torch.set_num_threads(1)

import _torch_tp as tp

ARCHS = ("stablelm-12b", "whisper-medium")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return tp.run_both(tmp_path_factory.mktemp("tp_adafactor"),
                       ("train",), archs=ARCHS, optimizers=("adafactor",),
                       tied=ARCHS[:1])


@pytest.mark.parametrize("arch", ARCHS)
def test_adafactor_step_matches_reference_mesh_run(runs, arch):
    tp.check_pot_step(runs, arch, "adafactor")


@pytest.mark.parametrize("arch", ARCHS)
def test_adafactor_step_is_the_same_on_every_rank(runs, arch):
    tp.check_same_on_every_rank(runs, arch, "adafactor")


@pytest.mark.parametrize("path", ("mesh", "dense"))
def test_tied_embeddings_match_reference_mesh_run(runs, path):
    tp.check_tied(runs, ARCHS[0], path)
