"""The port's whole model with tensor- and sequence-parallel attention
and MLP on 8 gloo ranks of a (2, 4) mesh against the reference's own
(2, 4) mesh run on 8 host devices (``tests/_torch_tp.py``), in float32,
stablelm-smoke and qwen-smoke: ``lm.forward``'s logits
(4 x 32 tokens, the sequence split over the model axis), ``lm.prefill``'s
last logits and each rank's cache shard (the reference's cache cut by
``lm.local_cache``: K/V heads over the model axis for qwen, rows for
the others), and one ``decode_step`` from a random cache cut to the
rank's shard, each within 1e-4 in relative L2 and bitwise the same on
every rank; a ``Session`` (prefill and 4 greedy steps, its page metadata
a shard per data rank) emits the same tokens and fingerprint on every
rank."""

import pytest
import torch

torch.set_num_threads(1)

import _torch_tp as tp


ARCHS = ("stablelm-12b", "qwen15-32b")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return tp.run_both(tmp_path_factory.mktemp("tp_model"),
                       ("model", "session"), archs=ARCHS)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_prefill_match_reference_mesh_run(runs, arch):
    tp.check_forward_and_prefill(runs, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_reference_mesh_run(runs, arch):
    tp.check_decode_step(runs, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_session_is_the_same_on_every_rank(runs, arch):
    tp.check_session(runs, arch)
