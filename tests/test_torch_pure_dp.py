"""``pure_dp`` on a mesh (the model axis as one more data axis: the
batch over all 8 ranks, every weight's FSDP shard over both axes
gathered whole at use, the embedding and head by vocab block gathered
over the model axis, no tensor or sequence parallelism) on 8 gloo ranks
of a (2, 4) mesh against the reference's ``Profile(mesh=,
pure_dp=True)`` run on its own (2, 4) mesh of 8 host devices
(``tests/_torch_tp.py``), in float32, stablelm-smoke (attention and
the SwiGLU MLP), 16 x 32 tokens:
``lm.forward``'s logits, ``lm.prefill``'s last logits and each rank's
cache shard (the reference's cache cut by ``lm.local_cache``: its batch
rows), one ``decode_step`` from a random cache cut to the rank's shard,
each within 1e-4 in relative L2 and bitwise the same on every rank, the
8 ranks' forward FLOPs between 1 and 1.5 x the dense forward's; a
``Session`` (prefill and 4 greedy steps) emits the same tokens and
fingerprint on every rank; one pot step (2 microbatches) with AdamW and
one with Adafactor: the loss within rtol 1e-5, every parameter, moment
and statistic leaf within 1e-4, a delayed rank's run bitwise the same,
each leaf and statistic bitwise the same on every rank that holds the
same block of it.  Tied embeddings (no config ties them: the head
``embed`` transposed, gathered over the model axis), on the rank's
shards and on the dense path, against the reference's mesh run of the
tied config: the logits and both pot steps as above."""

import pytest
import torch

torch.set_num_threads(1)

import _torch_tp as tp

ARCH = "stablelm-12b"
OPTIMIZERS = ("adamw", "adafactor")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return tp.run_both(tmp_path_factory.mktemp("pure_dp"),
                       ("model", "session", "train"), archs=(ARCH,),
                       batch=16, optimizers=OPTIMIZERS, tied=(ARCH,),
                       pure_dp=True)


def test_forward_and_prefill_match_reference_mesh_run(runs):
    tp.check_forward_and_prefill(runs, ARCH)


def test_forward_flops_are_shared_out(runs):
    tp.check_forward_flops(runs, ARCH)


def test_decode_step_matches_reference_mesh_run(runs):
    tp.check_decode_step(runs, ARCH)


def test_session_is_the_same_on_every_rank(runs):
    tp.check_session(runs, ARCH)


@pytest.mark.parametrize("optimizer", OPTIMIZERS)
def test_pot_step_matches_reference_mesh_run(runs, optimizer):
    tp.check_pot_step(runs, ARCH, optimizer)


@pytest.mark.parametrize("optimizer", OPTIMIZERS)
def test_pot_step_is_the_same_on_every_rank(runs, optimizer):
    tp.check_same_on_every_rank(runs, ARCH, optimizer)


@pytest.mark.parametrize("path", ("mesh", "dense"))
def test_tied_embeddings_match_reference_mesh_run(runs, path):
    tp.check_tied(runs, ARCH, path)
