"""Every layer's decode step against the JAX reference, each layer given
the reference's own input and cache: six teacher-forced decode steps
after the reference's prefill, at gemma3-, recurrentgemma-, mamba2-,
stablelm- and whisper-smoke.  After each step, each layer's output and
its whole cache (the global rows, the local ring, the mamba and RG-LRU
states and conv rows, whisper's cross rows) are held to the reference's
at the reference tests' tolerance, rtol = atol = 3e-2, as
``tests/test_torch_prefill.py`` holds each layer's prefill: a fault in
a deeper layer's decode branch shows there, not only through the
logits.

The reference's layer inputs are read off its own decode step (run
unrolled, op by op): the activation its ``decode_step`` hands each
layer's first norm.
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

TOL = dict(rtol=3e-2, atol=3e-2)
STEPS = 6


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("arch", ["gemma3_27b", "recurrentgemma_9b",
                                  "mamba2_370m", "stablelm_12b",
                                  "whisper_medium"])
def test_decode_layers_cache_like_the_reference(arch, monkeypatch):
    cfg, pcfg = ref_smoke_config(arch), get_smoke_config(arch)
    ref = ref_lm.init_params(jax.random.PRNGKey(3), cfg)
    port = convert.lm_params_from_numpy(jax.tree.map(np.asarray, ref), pcfg,
                                        device="cpu")
    rng = np.random.default_rng(103)
    tokens = rng.integers(0, cfg.vocab, (2, 16 + STEPS)).astype(np.int32)
    kw = {}
    if cfg.encoder_layers:
        frames = rng.normal(size=(2, cfg.n_frames, cfg.d_model)).astype(
            np.float32)
        kw["enc"] = ref_lm.encode(ref, jnp.asarray(frames), cfg, SMOKE)
    _, jcache = ref_lm.prefill(ref, jnp.asarray(tokens[:, :16]), cfg, SMOKE,
                               max_seq=16 + STEPS, unroll=True, **kw)
    kinds = lm.layer_kinds(pcfg)
    # which of the reference's lm-level norms open a layer: ln1, then
    # ln_x (cross-attention) and ln2 (an MLP) where the layer has them
    per_layer = [1 + ("xattn" in p) + ("mlp" in p or "moe" in p)
                 for p in port["layers"]]
    opens = np.cumsum([0] + per_layer)[:-1]
    pos = np.full((2,), 16, np.int32)
    n_checked = 0
    for i in range(16, 16 + STEPS):
        before = convert.lm_cache_from_numpy(
            jax.tree.map(np.asarray, jcache), pcfg, device="cpu")
        rec = []
        orig = ref_lm.rmsnorm

        def recording(x, scale, eps):
            rec.append(np.asarray(x, np.float32))
            return orig(x, scale, eps)
        monkeypatch.setattr(ref_lm, "rmsnorm", recording)
        _, jcache = ref_lm.decode_step(ref, jcache,
                                       jnp.asarray(tokens[:, i:i + 1]),
                                       jnp.asarray(pos), cfg, SMOKE,
                                       unroll=True)
        monkeypatch.setattr(ref_lm, "rmsnorm", orig)
        assert len(rec) == sum(per_layer) + 1       # + the final norm
        inputs = [rec[j] for j in opens] + [rec[-1]]
        after = convert.lm_cache_from_numpy(
            jax.tree.map(np.asarray, jcache), pcfg, device="cpu")
        for layer, kind in enumerate(kinds):
            c = before[layer]
            x = lm.decode_layer(port["layers"][layer],
                                torch.from_numpy(inputs[layer]).bfloat16(),
                                c, kind, torch.from_numpy(pos), pcfg)
            msg = f"step {i - 15}, layer {layer} ({kind})"
            np.testing.assert_allclose(_f32(x), inputs[layer + 1],
                                       err_msg=msg, **TOL)
            assert c.keys() == after[layer].keys()
            for name, t in c.items():
                assert t.shape == after[layer][name].shape
                np.testing.assert_allclose(_f32(t), _f32(after[layer][name]),
                                           err_msg=f"{msg} {name}", **TOL)
                n_checked += 1
        pos = pos + 1
    assert n_checked >= STEPS * len(kinds) * 2
