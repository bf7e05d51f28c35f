"""Tensor and sequence parallelism of the other layer kinds, beside
attention and the MLP, on 8 gloo ranks of a (2, 4) mesh against the
reference's own (2, 4) mesh run on 8 host devices
(``tests/_torch_tp.py``), in float32: recurrentgemma-smoke (the RG-LRU
mixers' width over the model axis after ``w_x``, their states and conv
rows the rank's channels, and the local ring's attention
tensor-parallel, its one K/V head's ring cut by rows).
``lm.forward``'s logits, ``lm.prefill``'s last logits and each rank's
cache shard (the reference's cache cut by ``lm.local_cache``), one
``decode_step`` from a random cache cut to the rank's shard, each within
1e-4 in relative L2 and bitwise the same on every rank; the 8 ranks'
forward FLOPs at most 1.5 times the dense forward's.  Its pot step is
in ``tests/test_torch_tp_kinds_ring_train.py``, the other kinds in
``tests/test_torch_tp_kinds.py``."""

import pytest
import torch

torch.set_num_threads(1)

import _torch_tp as tp

ARCHS = ("recurrentgemma-9b",)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return tp.run_both(tmp_path_factory.mktemp("tp_kinds_ring"),
                       ("model",), archs=ARCHS)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_prefill_match_reference_mesh_run(runs, arch):
    tp.check_forward_and_prefill(runs, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_flops_are_shared_out(runs, arch):
    tp.check_forward_flops(runs, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_reference_mesh_run(runs, arch):
    tp.check_decode_step(runs, arch)
