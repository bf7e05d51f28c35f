"""Training through every layer kind against the JAX reference at smoke
sizes, by family (the others: ``tests/test_torch_train_{local, moe,
moe_residual, ssm_encoder, dense, dense_patches}.py``; the DP step:
``tests/test_torch_dp_train_{kinds, moe_encoder}.py``; Adafactor's tree:
``tests/test_torch_adafactor_kinds.py``): here
recurrentgemma (RG-LRU, the local ring, the 2-layer tail), and
``mode="baseline"`` and the one-rank DP step of the new kinds.

The checks are ``tests/_torch_train.py``'s: one pot step of 2
microbatches from the reference's initial state, with AdamW and with
Adafactor, in float32 (``C`` set to float32 in both packages' model
modules: the loss within rtol 1e-5, every gradient, parameter and
Adafactor statistic within 1e-4 in relative L2 per leaf); one AdamW
step at bf16, each gradient leaf within max(3e-2, 2 x the port's own
bf16-to-float32 distance) of the reference's; and two runs of the
port's pot step, and a run under ``remat``, bitwise equal.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro_torch.configs import get_smoke_config
from repro_torch.train import make_pot_dp_step, make_train_step
from repro_torch.tree import leaves

from _torch_train import (F32_LEAF, F32_LOSS, LR, batch_np, bits,
                          check_bf16_gradients, check_deterministic,
                          check_float32_step, float32, port_initial,
                          port_step, ref_step, rel, undetermined)

ARCHS = ["recurrentgemma_9b"]


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


@pytest.mark.parametrize("arch", ["recurrentgemma_9b", "deepseek_moe_16b",
                                  "whisper_medium"])
def test_baseline_and_one_rank_dp_steps_train(arch):
    """``mode="baseline"`` and ``make_pot_dp_step`` at one rank take
    these kinds too: the one-rank DP step is the pot step bitwise, with
    AdamW and with Adafactor, and the baseline AdamW step (one gradient
    of the whole batch) matches the reference's baseline step in
    float32 (the pot steps hold Adafactor to the reference)."""
    cfg = get_smoke_config(arch)
    batch = batch_np(arch)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    for optimizer in ("adamw", "adafactor"):
        kw = dict(optimizer=optimizer, n_microbatches=2, lr=LR, remat=False)
        a, la = make_pot_dp_step(cfg, **kw)(port_initial(arch, optimizer), tb)
        b, lb = make_train_step(cfg, mode="pot", **kw)(
            port_initial(arch, optimizer), tb)
        assert torch.equal(la, lb)
        assert all(torch.equal(bits(x), bits(y))
                   for x, y in zip(leaves(a), leaves(b), strict=True))
    with float32():
        loss, new = port_step(arch, "adamw", batch, mode="baseline")
        rloss, exp = ref_step(arch, "adamw", batch, mode="baseline")
    np.testing.assert_allclose(loss, rloss, rtol=F32_LOSS)
    assert int(new.gv) == int(exp.gv) == 0 and int(new.step) == 1
    skip = undetermined([t.numpy() for t in leaves(new.opt["m"])],
                        [t.numpy() for t in leaves(exp.opt["m"])])
    assert len(skip) <= cfg.n_layers, skip
    n_params = len(leaves(new.params))
    for j, (x, y) in enumerate(zip(leaves([new.params, new.opt]),
                                   leaves([exp.params, exp.opt]),
                                   strict=True)):
        if j >= n_params or j not in skip:
            assert rel(x.numpy(), y.numpy()) <= F32_LEAF, j
