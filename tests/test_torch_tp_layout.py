"""The layout a rank holds on a (2, 4) ("data", "model") mesh, checked
at every coordinate in one process (``_torch_tp.CoordMesh``, no ranks):
each leaf of ``lm.local_params`` but the embedding and head has its
``lm.param_specs`` shard's shape (``shardings.local_shape``), each
decode-cache entry of ``lm.local_cache`` and of ``lm.init_cache(prof=)``
its ``lm.cache_specs`` shard's, and the dry run's per-card bytes of
those spec trees (``dryrun.tree_local_bytes``) are the bytes the rank
holds; a whole tree taken to the reference's stacked numpy layout and
back through ``convert`` is itself, and a rank's tree from it the same
cut.  (The values of the shards are held against the reference's own
mesh runs by the ``test_torch_tp_kinds*.py`` files.)
The mixers, whisper's encoder and cross-attention (the kinds tensor
parallelism reached last), and the MoE layers' shared experts and dense
residual, at the smoke configurations."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import _torch_tp as tp

from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.launch.dryrun import tree_local_bytes
from repro_torch.models import lm
from repro_torch.runtime.shardings import local_shape
from repro_torch.tree import flatten_up_to, leaves, tree_map

ARCHS = ("mamba2-370m", "recurrentgemma-9b", "whisper-medium",
         "deepseek-moe-16b", "arctic-480b")
COORDS = [(d, m) for d in range(tp.DATA) for m in range(tp.MODEL)]
SIZES = {"data": tp.DATA, "model": tp.MODEL}
B, MAX_SEQ = 4, 48


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
@pytest.mark.parametrize("arch", ARCHS)
def test_local_params_are_their_spec_shards(whole, arch, coord):
    cfg = get_smoke_config(arch)
    prof = tp.profile(coord)
    params = whole[arch][0]
    local = lm.local_params(params, cfg, prof)
    specs = lm.param_specs(cfg, prof)
    assert set(local) == set(params)
    cut = 0
    for name, sub in params.items():
        if name in lm.WHOLE:
            assert local[name] is sub
            continue
        for t, got, spec in zip(leaves(sub), leaves(local[name]),
                                flatten_up_to(sub, specs[name]),
                                strict=True):
            assert got.shape == local_shape(t.shape, spec, SIZES), spec
            assert got.dtype == t.dtype, spec
            cut += got.shape != t.shape
    assert cut
    rest = lambda tree: {k: v for k, v in tree.items() if k not in lm.WHOLE}
    assert tree_local_bytes(rest(params), rest(specs), SIZES) == \
        nbytes(rest(local))


@pytest.mark.parametrize("coord", COORDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_local_cache_is_its_spec_shards(whole, arch, coord):
    cfg = get_smoke_config(arch)
    prof = tp.profile(coord)
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
        prof = tp.profile(coord)
        got = convert.lm_params_from_numpy(tree, cfg, "cpu", torch.float32,
                                           prof)
        want = lm.local_params(params, cfg, prof)
        assert all(same(a, b) for a, b in zip(leaves(got), leaves(want),
                                              strict=True))
