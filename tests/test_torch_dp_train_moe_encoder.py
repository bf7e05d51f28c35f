"""Deterministic data-parallel training through the other layer kinds
against the JAX reference (``tests/_torch_train.py``
``check_dp_two_ranks``): ``make_pot_dp_step`` over 2 gloo ranks against
the reference's ``make_pot_dp_step`` on a 2-device host mesh, one step
of 2 microbatches a rank, AdamW and Adafactor, in float32 (``C`` set to
float32 in both packages' model modules): the losses within rtol 1e-5
and every gradient (AdamW's first moment), parameter and Adafactor
statistic within 1e-4 in relative L2 per leaf (the parameters of an
undetermined leaf are held through their gradients and statistics);
both ranks and two runs bitwise equal.  Here deepseek (MoE: its
capacity, and so its drops, follow each rank's slice of the batch) and
whisper (the encoder).
"""

import pytest
import torch

torch.set_num_threads(1)

from _torch_train import check_dp_two_ranks


@pytest.mark.parametrize("arch", ["deepseek_moe_16b", "whisper_medium"])
def test_dp_step_matches_reference_on_two_ranks(arch, tmp_path):
    check_dp_two_ranks(arch, tmp_path)
