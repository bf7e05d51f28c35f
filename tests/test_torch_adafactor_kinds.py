"""Adafactor over every layer kind against the JAX reference:
``adafactor_init``'s statistics tree (the pattern slots stack only the
grouped layers, each tail layer is unstacked under ``tail``, the
encoder is one stacked slot under ``enc_layers``), its carriage by
``convert.train_state_from_numpy``, and both sides of the clip rule
(``ndim >= 3``, more than one group and above 2e8 elements: entry by
entry, else over the whole stacked leaf) at the new leaves.

Updates are held within rtol 1e-5 and atol 1e-7 (the parameters of the
larger of |p| and |p'|), as ``tests/test_torch_optim.py`` holds them.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.optim import adafactor as ref_adafactor
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.optim import adafactor, adafactor_init, adafactor_update
from repro_torch.train import init_state
from repro_torch.tree import flatten_up_to, leaves

from _torch_train import port_initial, ref_initial


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        return {p: s for k, v in tree.items()
                for p, s in _paths(v, prefix + (str(k),)).items()}
    return {prefix: tuple(np.shape(tree))}


@pytest.mark.parametrize("arch", ["gemma3_27b", "recurrentgemma_9b",
                                  "whisper_medium"])
def test_adafactor_stats_tree_is_the_references(arch):
    """``adafactor_init``'s statistics, key by key and shape by shape:
    the pattern slots stack only the grouped layers, each tail layer is
    unstacked under ``tail``, the encoder is one stacked slot under
    ``enc_layers``; ``init_state(cfg=)`` lays them out the same."""
    cfg = get_smoke_config(arch)
    exp = _paths(ref_initial(arch, "adafactor")["opt"]["stats"])
    params = convert.lm_params_from_numpy(
        ref_initial(arch, "adafactor")["params"], cfg, device="cpu",
        dtype=torch.float32)
    got = adafactor_init(params, len(cfg.pattern), len(cfg.tail_pattern))
    assert _paths(got["stats"]) == exp
    state = init_state(params, "adafactor", cfg=cfg)
    assert _paths(state.opt["stats"]) == exp
    assert ("tail" in got["stats"]) == bool(cfg.tail_pattern)
    assert ("enc_layers" in got["stats"]) == bool(cfg.encoder_layers)


def test_train_state_from_numpy_checks_statistics():
    """The tail's and the encoder's statistics cross; a statistic of
    another shape, a missing one or an extra one raises."""
    for arch in ("recurrentgemma_9b", "whisper_medium"):
        tree = ref_initial(arch, "adafactor")
        tree = dict(tree, opt=dict(tree["opt"], stats=jax.tree.map(
            lambda a: np.random.default_rng(a.size).random(a.shape),
            tree["opt"]["stats"])))
        state = convert.train_state_from_numpy(tree, get_smoke_config(arch),
                                               device="cpu")
        key = "tail" if arch == "recurrentgemma_9b" else "enc_layers"
        src = tree["opt"]["stats"][key]
        got = state.opt["stats"][key]
        assert _paths(got) == _paths(src)
        for path in _paths(src):
            a, b = got, src
            for k in path:
                a, b = a[k], b[k]
            np.testing.assert_array_equal(a.numpy(), np.float32(b))
    cfg = get_smoke_config("gemma3_27b")
    tree = ref_initial("gemma3_27b", "adafactor")
    stats = tree["opt"]["stats"]
    bad = jax.tree.map(lambda a: a, stats)
    bad["layers"]["0"]["ln1"]["vr"] = np.zeros((2,), np.float32)
    with pytest.raises(ValueError, match="shape"):
        convert.train_state_from_numpy(
            dict(tree, opt=dict(tree["opt"], stats=bad)), cfg, device="cpu")
    short = {k: v for k, v in stats.items() if k != "tail"}
    with pytest.raises(ValueError, match="keys"):
        convert.train_state_from_numpy(
            dict(tree, opt=dict(tree["opt"], stats=short)), cfg,
            device="cpu")


def _grads(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (rng.standard_normal(a.shape) * np.where(
        rng.random(a.shape) < 0.01, 30.0, 1.0)).astype(np.float32), tree)


@pytest.mark.parametrize("arch", ["recurrentgemma_9b", "mamba2_370m",
                                  "deepseek_moe_16b", "whisper_medium"])
def test_adafactor_stack_wide_clip_at_new_leaves(arch):
    """The stack-wide side of the clip rule (every smoke leaf is below
    2e8): two updates of the whole tree with spiked random gradients,
    each against the reference's ``adafactor_update`` (rtol 1e-5 and
    atol 1e-7, the parameters of the larger of |p| and |p'|), at the
    new leaves: the (G, E, D, F) expert stacks, the conv weights, the
    per-head vectors, RG-LRU's gates, the tail and the encoder."""
    cfg = get_smoke_config(arch)
    ref = ref_initial(arch, "adafactor")
    rp, ropt = ref["params"], ref["opt"]
    state = port_initial(arch, "adafactor")
    params, opt = state.params, state.opt
    for i in range(2):
        g = _grads(rp, i)
        rp, ropt = ref_adafactor.adafactor_update(
            rp, jax.tree.map(jnp.asarray, g), ropt, lr=1e-2)
        before = params
        params, opt = adafactor_update(
            params, convert.lm_params_from_numpy(g, cfg, device="cpu",
                                                 dtype=torch.float32),
            opt, lr=1e-2)
        exp = convert.train_state_from_numpy(
            dict(ref, params=jax.tree.map(np.asarray, rp),
                 opt=jax.tree.map(np.asarray, ropt)), cfg, device="cpu")
        for a, b, p in zip(leaves(params), leaves(exp.params),
                           leaves(before), strict=True):
            scale = np.maximum(np.abs(b.numpy()), np.abs(p.numpy()))
            assert (np.abs(a.numpy() - b.numpy())
                    <= 1e-7 + 1e-5 * scale).all()
        for a, b in zip(leaves(opt["stats"]), leaves(exp.opt["stats"]),
                        strict=True):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                       atol=1e-7)


@pytest.mark.parametrize("arch", ["deepseek_moe_16b", "mamba2_370m"])
def test_adafactor_per_group_clip_at_new_leaves(arch, monkeypatch):
    """The per-group side, with the threshold patched down to 0: every
    stacked leaf of three or more dimensions (the (G, E, D, F) expert
    stacks, the attention and RG-LRU projections) is updated group by
    group, each group bitwise the port's own ``_leaf_core`` on that
    layer's tensor and statistics; the other leaves as before.  The
    clip domain is observable: the stack-wide update differs."""
    cfg = get_smoke_config(arch)
    state = port_initial(arch, "adafactor")
    grads = convert.lm_params_from_numpy(
        _grads(ref_initial(arch, "adafactor")["params"], 7), cfg,
        device="cpu", dtype=torch.float32)
    wide, _ = adafactor_update(state.params, grads, state.opt, lr=1e-2)
    monkeypatch.setattr(adafactor, "_GROUPED_ABOVE", 0)
    got, got_s = adafactor_update(state.params, grads, state.opt, lr=1e-2)
    core = functools.partial(adafactor._leaf_core, beta2=torch.tensor(0.0),
                             lr=1e-2, eps=1e-30, clip_threshold=1.0, wd=0.0)
    n_slots = len(cfg.pattern)
    n_grouped = cfg.n_groups * n_slots
    checked = differs = 0
    for i in range(n_slots):
        slot = state.params["layers"][i:n_grouped:n_slots]
        gslot = grads["layers"][i:n_grouped:n_slots]
        stats = flatten_up_to(slot[0], state.opt["stats"]["layers"][str(i)])
        for j, (p0, s) in enumerate(zip(leaves(slot[0]), stats)):
            if p0.dim() < 2:
                continue        # a (G, d) stack: two dimensions, clipped whole
            for g in range(len(slot)):
                exp, _ = core(leaves(slot[g])[j], leaves(gslot[g])[j],
                              {k: v[g] for k, v in s.items()})
                new = leaves(got["layers"][g * n_slots + i])[j]
                assert torch.equal(new, exp)
                differs += not torch.equal(
                    new, leaves(wide["layers"][g * n_slots + i])[j])
                checked += 1
    assert checked and differs
    assert int(got_s["step"]) == 1
