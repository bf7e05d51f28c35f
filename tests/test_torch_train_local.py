"""Training gemma3 (local layers around a global one, and a tail)
against the JAX reference at smoke size; and the forward logits of the
new kinds from float32 masters (the check ``tests/test_torch_train.py``
held them to while training them was still refused).

The checks are ``tests/_torch_train.py``'s: one pot step of 2
microbatches from the reference's initial state, with AdamW and with
Adafactor, in float32 (``C`` set to float32 in both packages' model
modules: the loss within rtol 1e-5, every gradient, parameter and
Adafactor statistic within 1e-4 in relative L2 per leaf); one AdamW
step at bf16, each gradient leaf within max(3e-2, 2 x the port's own
bf16-to-float32 distance) of the reference's; and two runs of the
port's pot step, and a run under ``remat``, bitwise equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import lm as ref_lm
from repro.runtime.shardings import SMOKE
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.models import lm

from _torch_train import (batch_np, check_bf16_gradients,
                          check_deterministic, check_float32_step)

TOL = dict(rtol=3e-2, atol=3e-2)

ARCHS = ["gemma3_27b"]


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


@pytest.mark.parametrize("arch", ["gemma3_27b", "mamba2_370m",
                                  "deepseek_moe_16b", "whisper_medium"])
def test_forward_logits_of_new_kinds_match_reference(arch):
    """Float32 masters of the new kinds give the reference's logits in
    bf16 (whisper with its encoder's output)."""
    cfg, rcfg = get_smoke_config(arch), ref_smoke_config(arch)
    ref = ref_lm.init_params(jax.random.PRNGKey(6), rcfg)
    port = convert.lm_params_from_numpy(jax.tree.map(np.asarray, ref), cfg,
                                        device="cpu", dtype=torch.float32)
    batch = batch_np(arch, 6, b=2)
    jenc = tenc = None
    if cfg.encoder_layers:
        jenc = ref_lm.encode(ref, jnp.asarray(batch["frames"]), rcfg, SMOKE)
        tenc = lm.encode(port, torch.from_numpy(batch["frames"]), cfg)
        assert tenc.dtype == torch.bfloat16
        np.testing.assert_allclose(tenc.float().numpy(),
                                   np.asarray(jenc, np.float32), **TOL)
    jlog = ref_lm.forward(ref, jnp.asarray(batch["tokens"]), rcfg, SMOKE,
                          enc=jenc, unroll=True)
    tlog = lm.forward(port, torch.from_numpy(batch["tokens"]), cfg, enc=tenc)
    assert tlog.dtype == torch.bfloat16 and tlog.shape == jlog.shape
    np.testing.assert_allclose(tlog.float().numpy(),
                               np.asarray(jlog, np.float32), **TOL)
