"""The yardstick's counts against hand counts and against the port's own
parameter tree (the tree's shapes only, on ``meta``)."""

from __future__ import annotations

import pytest
import torch
from conftest import ROOT

from potbench import spec
from potbench.yardstick import adamw, flops


def port(cell: str) -> dict:
    return spec.load_cell(ROOT, cell).config["port"]


def test_stablelm_flops_per_token_by_hand():
    d, f, v, layers, seq = 5120, 13824, 100352, 4, 4096
    attn = d * d + 2 * d * (8 * 160) + d * d      # wq, wk, wv, wo
    per_token = 6 * (layers * (attn + 3 * d * f) + d * v) \
        + 12 * layers * d * seq
    assert per_token == 10_758_389_760
    got = flops.model_flops_per_token(port("stablelm-12b.pretrain-4k"), seq)
    assert got == per_token
    assert round(got / 1e9, 2) == 10.76


@pytest.mark.parametrize("layers,count", [(4, 3_425_697_792),
                                          (3, 2_883_846_144)])
def test_deepseek_flops_per_token_by_hand(layers, count):
    """At 4 layers (3.43 GFLOP a token) and at the cell's 3."""
    d, f, v, seq = 2048, 1408, 102400, 1024
    layer = 4 * d * d + d * 64 + 6 * 3 * d * f + 2 * 3 * d * f
    per_token = 6 * (layers * layer + d * v) + 12 * layers * d * seq
    assert per_token == count
    p = dict(port("deepseek-moe-16b.sft-1k"), n_layers=layers)
    assert flops.model_flops_per_token(p, seq) == per_token
    if layers == 4:
        assert round(per_token / 1e9, 2) == 3.43


def test_adamw_bytes_per_element():
    assert adamw.bytes_per_element(4) == 28
    assert adamw.bytes_per_element(2) == 26
    with pytest.raises(ValueError):
        adamw.bytes_per_element(1)


@pytest.mark.parametrize("cell,count", [
    ("stablelm-12b.pretrain-4k", 2_139_141_120),
    ("deepseek-moe-16b.sft-1k", 2_183_018_496)])
def test_param_elements_match_the_port_tree(cell, count):
    from repro_torch.models import lm
    from repro_torch.models.config import ModelConfig

    p = port(cell)
    assert adamw.param_elements(p) == count
    cfg = ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                         for k, v in p.items()})
    tree = lm.init_params(None, cfg, dtype=torch.float32, device="meta")
    from potbench.reference.common import flatten
    assert sum(t.numel() for _, t in flatten(tree)) == count


def test_flops_refuse_other_layer_kinds():
    p = dict(port("stablelm-12b.pretrain-4k"), pattern=["mamba"])
    with pytest.raises(ValueError):
        flops.model_flops_per_token(p, 128)


def test_active_params_of_moe_count_topk_and_shared_only():
    p = port("deepseek-moe-16b.sft-1k")
    dense_equiv = dict(p, n_experts=0, d_ff=(p["top_k"] + 2) * p["d_ff"])
    router = p["n_layers"] * p["d_model"] * p["n_experts"]
    assert flops.active_matmul_params(p) == \
        flops.active_matmul_params(dense_equiv) + router
