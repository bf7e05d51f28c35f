"""The plain reference held against the port at small widths on the CPU.

In float32 (activations and weights) the port's attention, SwiGLU and
MoE sublayers compute the reference's equations up to the order of
float32 sums, so they agree to 1e-5; the MoE case has experts past
their capacity, so the drop rule is held too.  The whole loss and its
gradients, which the port computes with bf16 products, agree with the
float32 reference to bf16's rounding."""

from __future__ import annotations

import contextlib
import subprocess
import sys

import pytest
import torch
from conftest import ROOT, tiny_cell

from potbench.bench import model_config
from potbench.reference import common, dense, moe
from potbench.weights import Weights

F32 = dict(rtol=1e-5, atol=1e-5)


def params_of(cell, seed=3):
    from repro_torch.models import lm
    cfg = model_config(cell.config)
    w = Weights(lm.init_params(None, cfg, dtype=torch.float32,
                               device="meta"), seed, "cpu")
    return cfg, w.build()


def test_attention_and_swiglu_match_the_port_in_float32():
    from repro_torch.models import blocks
    cell = tiny_cell("stablelm-12b.pretrain-4k")
    cfg, params = params_of(cell)
    x = torch.randn(2, 64, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    lp = params["layers"][0]
    port = cell.config["port"]
    prec = common.Precision()
    torch.testing.assert_close(
        common.attention(lp["attn"], x, port, prec),
        blocks.attn_apply(lp["attn"], x, cfg), **F32)
    torch.testing.assert_close(common.swiglu(lp["mlp"], x, prec),
                               blocks.mlp_apply(lp["mlp"], x, cfg), **F32)
    torch.testing.assert_close(
        common.rmsnorm(x, lp["ln1"] * 1.5, cfg.norm_eps),
        blocks.rmsnorm(x, lp["ln1"] * 1.5, cfg.norm_eps), **F32)


def test_bf16_scores_round_attention_products_alone():
    """The control ``bfloat16_scores`` leaves every other product in
    float32 and moves attention's output by about bf16's rounding."""
    cell = tiny_cell("stablelm-12b.pretrain-4k")
    cfg, params = params_of(cell)
    x = torch.randn(2, 64, cfg.d_model, generator=torch.Generator()
                    .manual_seed(2))
    lp, port = params["layers"][0], cell.config["port"]
    f32, low = common.Precision(), common.Precision("bfloat16_scores")
    torch.testing.assert_close(common.swiglu(lp["mlp"], x, low),
                               common.swiglu(lp["mlp"], x, f32),
                               rtol=0, atol=0)
    want = common.attention(lp["attn"], x, port, f32)
    gap = (common.attention(lp["attn"], x, port, low) - want).norm() \
        / want.norm()
    assert 1e-5 < gap < 2e-2
    with pytest.raises(ValueError):
        common.Precision("bfloat16")


@pytest.mark.parametrize("capacity_factor,drops", [(1.25, False),
                                                   (0.5, True)])
def test_moe_matches_the_port_in_float32(capacity_factor, drops):
    import dataclasses

    from repro_torch.models import moe as port_moe
    cell = tiny_cell("deepseek-moe-16b.sft-1k")
    cfg, params = params_of(cell)
    cfg = dataclasses.replace(cfg, capacity_factor=capacity_factor)
    port = dict(cell.config["port"], capacity_factor=capacity_factor)
    x = torch.randn(4, 64, cfg.d_model, generator=torch.Generator()
                    .manual_seed(2))
    p = params["layers"][0]["moe"]
    got = port_moe.moe_apply(p, x, cfg)
    want = moe.moe(p, x, port, common.Precision())
    torch.testing.assert_close(want, got, **F32)
    # at 0.5 the drop rule is exercised: an expert is routed past capacity
    t = x.shape[0] * x.shape[1]
    _, eidx = port_moe.route(x.reshape(t, -1), p["router"], cfg.top_k)
    load = torch.bincount(eidx.reshape(-1), minlength=cfg.n_experts)
    cap = port_moe.capacity(t, cfg.top_k, cfg.n_experts, capacity_factor)
    assert (int(load.max()) > cap) == drops


@contextlib.contextmanager
def port_compute(dtype):
    """The port's compute dtype ``C`` set to ``dtype`` (its model modules
    read it at each call)."""
    from repro_torch.models import blocks, lm
    from repro_torch.models import moe as port_moe
    mods = (blocks, lm, port_moe)
    saved = [m.C for m in mods]
    for m in mods:
        m.C = dtype
    try:
        yield
    finally:
        for m, c in zip(mods, saved):
            m.C = c


def port_loss_and_grads(params, batch, cfg, dtype, monkeypatch):
    """The port's loss and gradients with ``C`` = ``dtype``, and the
    experts each MoE call routed every token to, with their router
    probabilities."""
    from repro_torch.models import moe as port_moe
    from repro_torch.train.train_step import _value_and_grad, loss_fn
    routes, route = [], port_moe.route

    def recorded(xt, router, k):
        probs = torch.softmax((xt @ router.to(xt.dtype)).float(), -1)
        routes.append(probs.detach())
        return route(xt, router, k)
    monkeypatch.setattr(port_moe, "route", recorded)
    with port_compute(dtype):
        loss, grads = _value_and_grad(lambda p, b: loss_fn(p, b, cfg),
                                      params, batch)
    monkeypatch.setattr(port_moe, "route", route)
    return loss, grads, routes


@pytest.mark.parametrize("name", ["stablelm-12b.pretrain-4k",
                                  "deepseek-moe-16b.sft-1k"])
def test_loss_and_gradients_match_the_port_to_bf16(name, monkeypatch):
    """In float32 the port's loss and every gradient are the reference's
    to float32's sums; with its bf16 products, to bf16's rounding.  A
    token that bf16 routes to other experts than float32 does moves the
    gradients that reach it by more than rounding: such splits have to
    be few, those of the first layer near ties of the token's k-th and
    next expert, and the gradients are then held by the float32
    comparison alone."""
    cell = tiny_cell(name)
    cfg, params = params_of(cell)
    port = cell.config["port"]
    g = torch.Generator().manual_seed(5)
    tok = torch.randint(0, cfg.vocab, (2, 65), generator=g)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    loss32, grads32, routes32 = port_loss_and_grads(
        params, batch, cfg, torch.float32, monkeypatch)
    loss, grads, routes = port_loss_and_grads(params, batch, cfg,
                                              torch.bfloat16, monkeypatch)
    family = dense if port["family"] == "dense" else moe
    leaves = [t for _, t in common.flatten(params)]
    for t in leaves:
        t.requires_grad_(True)
    ref = family.accumulate(params, batch["tokens"], batch["labels"], port,
                            common.Precision(), 1.0)
    assert abs(float(loss32) - float(ref)) < 1e-5 * float(ref)
    for (path, a), b in zip(common.flatten(grads32), leaves):
        assert float((a - b.grad).norm()) <= 1e-4 * float(b.grad.norm()), \
            path
    split, k = False, cfg.top_k
    for i, (p32, p16) in enumerate(zip(routes32, routes)):
        top32 = p32.topk(k + 1, -1).values
        moved = (p32.topk(k, -1).indices.sort(-1).values
                 != p16.topk(k, -1).indices.sort(-1).values).any(-1)
        assert float(moved.float().mean()) <= 1 / 16
        if i == 0:  # the first layer's inputs differ by rounding alone
            tie = (top32[:, k - 1] - top32[:, k]) < 2e-2 * top32[:, k - 1]
            assert bool((tie | ~moved).all())
        split |= bool(moved.any())
    assert abs(float(loss) - float(ref)) < 2e-3 * float(ref)
    if split:
        return
    for (path, a), b in zip(common.flatten(grads), leaves):
        cos = torch.nn.functional.cosine_similarity(
            a.flatten(), b.grad.flatten(), dim=0)
        assert cos > 0.99, path
        assert abs(float(a.norm()) / float(b.grad.norm()) - 1) < 0.05, path


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path[:0] = [sys.argv[1]]; "
            "import potbench.reference.common, potbench.reference.dense, "
            "potbench.reference.moe; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)],
                         capture_output=True, text=True, check=True)
    names = eval(out.stdout)
    for bad in ("repro_torch", "repro", "jax", "jaxlib", "flax"):
        assert bad not in names
