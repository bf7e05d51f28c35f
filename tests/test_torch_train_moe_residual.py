"""Training arctic (MoE: 128 routed experts top-2 beside a dense
residual FFN, at smoke size 8) against the JAX reference (deepseek:
``tests/test_torch_train_moe.py``).  Capacity follows each call's
tokens in both packages, so the microbatch split moves the drops alike;
the bf16 batch is one on which both packages route every token alike
(asserted; at data step 0 two tokens route apart on a near-tie).

The checks are ``tests/_torch_train.py``'s: one pot step of 2
microbatches from the reference's initial state, with AdamW and with
Adafactor, in float32 (``C`` set to float32 in both packages' model
modules: the loss within rtol 1e-5, every gradient, parameter and
Adafactor statistic within 1e-4 in relative L2 per leaf); one AdamW
step at bf16, each gradient leaf within max(3e-2, 2 x the port's own
bf16-to-float32 distance) of the reference's; and two runs of the
port's pot step, and a run under ``remat``, bitwise equal.
"""

import pytest
import torch

torch.set_num_threads(1)

from _torch_train import (check_bf16_gradients, check_deterministic,
                          check_float32_step)

ARCHS = ["arctic_480b"]


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", ARCHS)
def test_float32_pot_step_matches_reference(arch, optimizer):
    check_float32_step(arch, optimizer)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_gradients_match_reference(arch, monkeypatch):
    check_bf16_gradients(arch, monkeypatch)


@pytest.mark.parametrize("arch", ARCHS)
def test_pot_step_is_deterministic(arch):
    check_deterministic(arch)
