"""Tensor and sequence parallelism of the other layer kinds, beside
attention and the MLP, on 8 gloo ranks of a (2, 4) mesh against the
reference's own (2, 4) mesh run on 8 host devices
(``tests/_torch_tp.py``), in float32: mamba2-smoke (the SSD mixer's
heads over the model axis: ``w_in`` gathered whole and cut to the
rank's heads and all of B and C, the gated RMSNorm's mean square summed
over the model axis, the decode state the rank's heads, the conv rows
whole on the model axis).
``lm.forward``'s logits, ``lm.prefill``'s last logits and each rank's
cache shard (the reference's cache cut by ``lm.local_cache``), one
``decode_step`` from a random cache cut to the rank's shard, and one pot
step (AdamW, 2 microbatches): logits, caches and new leaves within 1e-4
in relative L2, the loss within rtol 1e-5, bitwise the same with a rank
joining each backward 0.2 s late, and the leaves every rank holds whole
bitwise the same on every rank; the 8 ranks' forward FLOPs at most 1.5
times the dense forward's.  whisper's encoder and cross-attention
are in ``tests/test_torch_tp_kinds_whisper.py``, RG-LRU with the local
ring in ``tests/test_torch_tp_kinds_ring.py``, internvl2's patch prefix
in ``tests/test_torch_tp_kinds_patches.py`` (one architecture a file, to
keep each file's reference compiles short), the MoE layer's expert
parallelism in ``tests/test_torch_moe_ep*.py``."""

import pytest
import torch

torch.set_num_threads(1)

import _torch_tp as tp

ARCHS = ("mamba2-370m",)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return tp.run_both(tmp_path_factory.mktemp("tp_kinds"),
                       ("model", "train"), archs=ARCHS)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_prefill_match_reference_mesh_run(runs, arch):
    tp.check_forward_and_prefill(runs, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_flops_are_shared_out(runs, arch):
    tp.check_forward_flops(runs, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_reference_mesh_run(runs, arch):
    tp.check_decode_step(runs, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_pot_step_matches_reference_mesh_run(runs, arch):
    tp.check_pot_step(runs, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_pot_step_is_the_same_on_every_rank(runs, arch):
    tp.check_same_on_every_rank(runs, arch)
