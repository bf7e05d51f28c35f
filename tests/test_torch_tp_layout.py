"""The layout a rank holds on a (2, 4) ("data", "model") mesh, checked
at every coordinate in one process (``_torch_tp.CoordMesh``, no ranks),
under the (data, model) profile and under ``pure_dp``: each leaf of
``lm.local_params``, the embedding and head by vocab block, has its
``lm.param_specs`` shard's shape (``shardings.local_shape``), each
decode-cache entry of ``lm.local_cache`` and of ``lm.init_cache(prof=)``
its ``lm.cache_specs`` shard's, and the dry run's per-card bytes of
those spec trees (``dryrun.tree_local_bytes``) are the bytes the rank
holds, for the whole tree; a whole tree taken to the reference's
stacked numpy layout and back through ``convert`` is itself, and a
rank's tree from it the same cut, an Adafactor state's statistics too
(a leaf's ``vr`` cut by its spec without the last entry, its ``vc``
without the second last).  A MoE config under ``pure_dp`` is refused:
its expert specs name the model axis twice.  (The values of the shards
are held against the reference's own mesh runs by the
``test_torch_tp_kinds*.py`` and ``test_torch_pure_dp*.py`` files.)
The mixers, whisper's encoder and cross-attention, and the MoE layers'
shared experts and dense residual, at the smoke configurations."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import _torch_tp as tp

from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.launch.dryrun import tree_local_bytes
from repro_torch.models import lm
from repro_torch.optim import adafactor_init
from repro_torch.runtime.shardings import (P, local_shape, local_shard,
                                           norm_spec)
from repro_torch.tree import flatten_up_to, leaves, tree_map

ARCHS = ("mamba2-370m", "recurrentgemma-9b", "whisper-medium",
         "deepseek-moe-16b", "arctic-480b")
MOE = ("deepseek-moe-16b", "arctic-480b")
COORDS = [(d, m) for d in range(tp.DATA) for m in range(tp.MODEL)]
SIZES = {"data": tp.DATA, "model": tp.MODEL}
PROFILES = {"tp": {}, "pure_dp": {"pure_dp": True}}
# every arch under the (data, model) profile, the dense ones under pure_dp
CASES = [(arch, name) for name in PROFILES for arch in ARCHS
         if not (name == "pure_dp" and arch in MOE)]
B, MAX_SEQ = 8, 48


def same(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in leaves(tree))


@pytest.fixture(scope="module")
def whole():
    """Each arch's whole parameters (float32) and a decode cache of
    random values."""
    out = {}
    for arch in ARCHS:
        cfg = get_smoke_config(arch)
        gen = torch.Generator().manual_seed(ARCHS.index(arch))
        cache = lm.init_cache(cfg, B, MAX_SEQ, "cpu", dtype=torch.float32)
        for c in cache:
            for t in c.values():
                t.normal_(generator=gen)
        out[arch] = (lm.init_params(gen, cfg, dtype=torch.float32), cache)
    return out


@pytest.mark.parametrize("coord", COORDS)
@pytest.mark.parametrize("arch, prof_name", CASES)
def test_local_params_are_their_spec_shards(whole, arch, prof_name, coord):
    cfg = get_smoke_config(arch)
    prof = tp.profile(coord, **PROFILES[prof_name])
    params = whole[arch][0]
    local = lm.local_params(params, cfg, prof)
    specs = lm.param_specs(cfg, prof)
    assert set(local) == set(params)
    cut = 0
    for name, sub in params.items():
        for t, got, spec in zip(leaves(sub), leaves(local[name]),
                                flatten_up_to(sub, specs[name]),
                                strict=True):
            assert got.shape == local_shape(t.shape, spec, SIZES), spec
            assert got.dtype == t.dtype, spec
            cut += got.shape != t.shape
    # the embedding and the head by vocab block over the model axis
    for name, dim, spec in (("embed", 0, P("model", None)),
                            ("head", 1, P(None, "model"))):
        if name in params:
            assert specs[name] == spec
            assert local[name].shape[dim] * tp.MODEL == \
                params[name].shape[dim]
            assert torch.equal(local[name], local_shard(
                params[name], specs[name], prof.mesh))
    assert cut
    assert tree_local_bytes(params, specs, SIZES) == nbytes(local)


@pytest.mark.parametrize("arch", MOE)
def test_pure_dp_refuses_moe(whole, arch):
    """The expert specs under ``pure_dp`` name the model axis twice:
    ``lm.local_params`` and the MoE layer refuse them, as the
    reference's ``shard_map`` fails on them."""
    from repro_torch.models import moe
    cfg = get_smoke_config(arch)
    prof = tp.profile((1, 2), pure_dp=True)
    with pytest.raises(ValueError, match=r"mesh axis model twice"):
        lm.local_params(whole[arch][0], cfg, prof)
    x = torch.zeros((B, 8, cfg.d_model))
    with pytest.raises(ValueError, match=r"name the model axis 'model' "
                                         r"twice"):
        moe.moe_apply(whole[arch][0]["layers"][0]["moe"], x, cfg, prof)


@pytest.mark.parametrize("coord", COORDS)
@pytest.mark.parametrize("arch, prof_name", CASES)
def test_local_cache_is_its_spec_shards(whole, arch, prof_name, coord):
    cfg = get_smoke_config(arch)
    prof = tp.profile(coord, **PROFILES[prof_name])
    cache = whole[arch][1]
    local = lm.local_cache(cache, cfg, prof)
    specs = lm.cache_specs(cfg, prof, tp.MODEL)
    zeros = lm.init_cache(cfg, B, MAX_SEQ, "cpu", dtype=torch.float32,
                          prof=prof)
    for c, got, zero, spec in zip(cache, local, zeros, specs, strict=True):
        assert set(got) == set(c) == set(zero) == set(spec)
        for name, t in c.items():
            shape = local_shape(t.shape, spec[name], SIZES)
            assert got[name].shape == zero[name].shape == shape, name
            assert got[name].dtype == zero[name].dtype == t.dtype, name
            assert not zero[name].any()
    assert tree_local_bytes(cache, specs, SIZES) == nbytes(local)


def reference_layout(params, cfg) -> dict:
    """A whole parameter tree in the reference's layout as numpy: each
    pattern slot's layers stacked over the groups, the tail's by slot,
    the encoder's stacked."""
    stack = lambda layers: tree_map(lambda *ts: np.stack(
        [t.numpy() for t in ts]), *layers)
    n, g = len(cfg.pattern), cfg.n_groups
    layers = params["layers"]
    tree = {k: params[k].numpy() for k in ("embed", "final_norm", "head")
            if k in params}
    tree["layers"] = {str(i): stack(layers[i:g * n:n]) for i in range(n)}
    tree["tail"] = {str(i): tree_map(lambda t: t.numpy(), p)
                    for i, p in enumerate(layers[g * n:])}
    if "enc_layers" in params:
        tree["enc_layers"] = stack(params["enc_layers"])
        tree["enc_norm"] = params["enc_norm"].numpy()
    return tree


@pytest.mark.parametrize("arch", ARCHS)
def test_rank_trees_through_convert_are_cut_alike(whole, arch):
    cfg = get_smoke_config(arch)
    params = whole[arch][0]
    tree = reference_layout(params, cfg)
    back = convert.lm_params_from_numpy(tree, cfg, "cpu", torch.float32)
    assert all(same(a, b) for a, b in zip(leaves(back), leaves(params),
                                          strict=True))
    for coord in COORDS:
        for name, kw in PROFILES.items():
            if name == "pure_dp" and arch in MOE:
                continue
            prof = tp.profile(coord, **kw)
            got = convert.lm_params_from_numpy(tree, cfg, "cpu",
                                               torch.float32, prof)
            want = lm.local_params(params, cfg, prof)
            assert all(same(a, b) for a, b in zip(
                leaves(got), leaves(want), strict=True))


def _stat_cuts(params, specs, cfg) -> list:
    """Each Adafactor statistic's spec, in ``adafactor_init``'s leaf
    order, by the rule itself: a pattern slot's stack (and the
    encoder's) a leading uncut group axis, a factored leaf's ``vr`` its
    spec without the last entry, its ``vc`` without the second last, an
    unfactored leaf's ``v`` its spec."""
    def stat(t, spec, stacked):
        full = (None,) * stacked + norm_spec(spec, t.ndim)
        if t.ndim + stacked < 2:
            return [P(*full)]
        return [P(*full[:-1]), P(*(full[:-2] + full[-1:]))]

    def layer(p, sp, stacked):
        return [c for t, s in zip(leaves(p), flatten_up_to(p, sp),
                                  strict=True) for c in stat(t, s, stacked)]
    n_slots, n_tail = len(cfg.pattern), len(cfg.tail_pattern)
    n_grouped = len(params["layers"]) - n_tail
    out = []
    for k, p in params.items():
        if k == "layers":
            for i in range(n_slots):
                out += layer(p[i], specs[k][i], 1)
            for j in range(n_grouped, n_grouped + n_tail):
                out += layer(p[j], specs[k][j], 0)
        elif k == "enc_layers":
            out += layer(p[0], specs[k][0], 1)
        else:
            out += stat(p, specs[k], 0)
    return out


@pytest.mark.parametrize("coord", COORDS)
@pytest.mark.parametrize("arch, prof_name", [
    ("recurrentgemma-9b", "tp"), ("whisper-medium", "tp"),
    ("deepseek-moe-16b", "tp"), ("recurrentgemma-9b", "pure_dp"),
    ("whisper-medium", "pure_dp")])
def test_adafactor_state_cuts_to_each_rank(whole, arch, prof_name, coord):
    """``convert.train_state_from_numpy`` of an Adafactor state (the
    reference's stacked statistics, random values) under a profile: the
    rank's parameters ``lm.local_params``' and each statistic the whole
    one cut by the leaf's spec without its last (``vr``) or second last
    (``vc``) entry, of the shape ``adafactor_init`` gives the rank's
    parameters."""
    cfg = get_smoke_config(arch)
    prof = tp.profile(coord, **PROFILES[prof_name])
    params = whole[arch][0]
    gen = torch.Generator().manual_seed(11)
    stats = tree_map(lambda t: torch.randn(t.shape, generator=gen),
                     adafactor_init(params, len(cfg.pattern),
                                    len(cfg.tail_pattern))["stats"])
    ref = {"params": reference_layout(params, cfg),
           "opt": {"stats": tree_map(lambda t: t.numpy(), stats),
                   "step": np.int32(3)},
           "gv": np.int32(3), "step": np.int32(3)}
    got = convert.train_state_from_numpy(ref, cfg, "cpu", prof)
    local = lm.local_params(params, cfg, prof)
    assert all(same(a, b) for a, b in zip(leaves(got.params), leaves(local),
                                          strict=True))
    mine = leaves(got.opt["stats"])
    shapes = [t.shape for t in leaves(adafactor_init(
        local, len(cfg.pattern), len(cfg.tail_pattern))["stats"])]
    cuts = _stat_cuts(params, lm.param_specs(cfg, prof), cfg)
    assert [t.shape for t in mine] == shapes
    n_cut = 0
    for t, whole_t, spec in zip(mine, leaves(stats), cuts, strict=True):
        assert same(t, local_shard(whole_t, spec, prof.mesh)), spec
        n_cut += t.shape != whole_t.shape
    assert n_cut
    assert int(got.opt["step"]) == int(got.gv) == int(got.step) == 3
