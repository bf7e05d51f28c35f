"""Parity of the port's sharding profiles and spec trees with the JAX
reference (``repro.runtime.shardings``, the models' ``*_specs``,
``repro.launch.dryrun.opt_specs``), and ``to_placements`` over a gloo
mesh of 2 ranks.

The reference's ``PartitionSpec`` is taken as a tuple.  Its trees stack
each pattern slot's layers with a leading ``None`` (the group axis) and
keep the tail, whisper's cross-attention rows and the encoder apart; the
port's keep one dict per layer (``lm.layer_kinds`` order), so the
reference's entries are mapped there: layer g * len(pattern) + i takes
slot i's specs without the leading ``None``, tail layer j the tail's
j-th.  Every architecture, full and smoke, under five profiles.
"""

import functools
import os

import jax
import pytest
import torch
from jax.sharding import PartitionSpec
from torch.distributed.tensor import Replicate, Shard

torch.set_num_threads(1)

import _torch_dist

from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke_config as ref_get_smoke_config
from repro.models import lm as ref_lm
from repro.runtime import shardings as ref_shardings
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.launch import dryrun
from repro_torch.models import lm
from repro_torch.runtime import shardings
from repro_torch.runtime.shardings import P, Profile
from repro_torch.train import init_state
from repro_torch.tree import flatten_up_to, leaves

PROFILES = {
    "single_pod": {},
    "multi_pod": {"data_axes": ("pod", "data")},
    "pure_dp": {"pure_dp": True},
    "replicated_batch": {"replicated_batch": True},
    "no_fsdp": {"fsdp": False},
}
SIZES = ("full", "smoke")
ACCESSORS = ("act_btd", "act_gathered", "act_bthd", "act_btf", "act_btv",
             "batch", "embed", "head", "w_in", "w_out", "bias_ff",
             "experts_in", "experts_out", "vector")


def _profiles(name):
    return Profile(**PROFILES[name]), ref_shardings.Profile(**PROFILES[name])


def _configs(arch, size):
    if size == "full":
        return get_config(arch), ref_get_config(arch)
    return get_smoke_config(arch), ref_get_smoke_config(arch)


def _tuples(tree):
    """A spec tree with every spec a plain tuple."""
    if isinstance(tree, (P, PartitionSpec)):
        return tuple(tree)
    if isinstance(tree, dict):
        return {k: _tuples(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tuples(v) for v in tree]
    raise TypeError(type(tree))


def _strip(tree):
    """A stacked slot's spec tree without its leading group axis."""
    if isinstance(tree, tuple):
        assert tree[0] is None, tree
        return tree[1:]
    return {k: _strip(v) for k, v in tree.items()}


def _per_layer(cfg, slots, tail):
    """The reference's slot and tail trees in the port's layer order."""
    n = len(cfg.pattern)
    grouped = cfg.n_groups * n
    return [_strip(slots[str(i % n)]) if i < grouped
            else tail[str(i - grouped)] for i in range(cfg.n_layers)]


def _expected_params(cfg, ref):
    out = {k: ref[k] for k in ("embed", "final_norm", "head", "enc_norm")
           if k in ref}
    out["layers"] = _per_layer(cfg, ref["layers"], ref.get("tail", {}))
    if cfg.encoder_layers:
        out["enc_layers"] = [_strip(ref["enc_layers"])] * cfg.encoder_layers
    return out


@functools.lru_cache(maxsize=None)
def _meta_params(arch, size):
    cfg = _configs(arch, size)[0]
    return lm.init_params(None, cfg, dtype=torch.float32, device="meta")


@functools.lru_cache(maxsize=None)
def _ref_shapes(arch, size):
    ref_cfg = _configs(arch, size)[1]
    return jax.eval_shape(
        lambda: ref_lm.init_params(jax.random.PRNGKey(0), ref_cfg))


@pytest.fixture(scope="module")
def ref_dryrun():
    """The reference's dry-run module, whose import sets ``XLA_FLAGS``
    for a 512-device host: imported after this process's backend is up
    (so the flag changes nothing here), the variable restored after."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as module
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return module


def _assert_fits(tree, specs):
    """``specs`` holds ``tree``'s structure, no spec longer than its
    leaf's rank."""
    flat = flatten_up_to(tree, specs)
    assert len(flat) == len(leaves(tree))
    for t, s in zip(leaves(tree), flat):
        assert isinstance(s, P) and len(s) <= t.ndim, (tuple(t.shape), s)


@pytest.mark.parametrize("name", list(PROFILES))
def test_profile_accessors(name):
    port, ref = _profiles(name)
    assert port.da == ref.da and port.ma == ref.ma
    for acc in ACCESSORS:
        assert tuple(getattr(port, acc)()) == tuple(getattr(ref, acc)()), acc
    for n_kv in (1, 2, 8, 16, 40):
        for m in (1, 8, 16):
            assert tuple(port.cache_kv(n_kv, m)) == tuple(
                ref.cache_kv(n_kv, m)), (n_kv, m)
    assert repr(P("data", None)) == repr(PartitionSpec("data", None))


@pytest.mark.parametrize("n_kv,model,sharded", [
    (8, 8, "heads"), (8, 16, "rows"), (1, 8, "rows")])
def test_cache_kv_divisibility(n_kv, model, sharded):
    """stablelm's 8 KV heads shard over a model axis of 8 and not of 16;
    recurrentgemma's one KV head never does."""
    port, ref = _profiles("single_pod")
    spec = port.cache_kv(n_kv, model)
    assert tuple(spec) == tuple(ref.cache_kv(n_kv, model))
    assert spec == (P("data", None, "model", None) if sharded == "heads"
                    else P("data", "model", None, None))


@pytest.mark.parametrize("name", list(PROFILES))
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch, size, name):
    cfg, ref_cfg = _configs(arch, size)
    port_prof, ref_prof = _profiles(name)
    got = lm.param_specs(cfg, port_prof)
    _assert_fits(_meta_params(arch, size), got)
    ref = _tuples(ref_lm.param_specs(ref_cfg, ref_prof))
    assert _tuples(got) == _expected_params(cfg, ref)


@pytest.mark.parametrize("name", list(PROFILES))
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_reference(arch, size, name):
    cfg, ref_cfg = _configs(arch, size)
    port_prof, ref_prof = _profiles(name)
    cache = lm.init_cache(cfg, 2, 32, "meta")
    for model in (8, 16):
        got = lm.cache_specs(cfg, port_prof, model)
        _assert_fits(cache, got)
        ref = _tuples(ref_lm.cache_specs(ref_cfg, ref_prof, model))
        want = _per_layer(cfg, ref, ref.get("tail", {}))
        if cfg.encoder_layers:
            cross = {"xk": _strip(ref["cross_k"]),
                     "xv": _strip(ref["cross_v"])}
            want = [dict(c, **cross) for c in want]
        assert _tuples(got) == want, model


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
@pytest.mark.parametrize("name", list(PROFILES))
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("arch", ARCHS)
def test_opt_specs_match_reference(arch, size, name, optimizer, ref_dryrun):
    cfg, ref_cfg = _configs(arch, size)
    port_prof, ref_prof = _profiles(name)
    params = _meta_params(arch, size)
    pspecs = lm.param_specs(cfg, port_prof)
    got = dryrun.opt_specs(pspecs, params, optimizer, cfg)
    _assert_fits(init_state(params, optimizer, cfg=cfg).opt, got)
    ref_p = ref_lm.param_specs(ref_cfg, ref_prof)
    ref = _tuples(ref_dryrun.opt_specs(ref_p, _ref_shapes(arch, size),
                                       optimizer))
    if optimizer == "adamw":
        want = _expected_params(cfg, _tuples(ref_p))
        ref = dict(ref, m=want, v=want)
    assert _tuples(got) == ref


@pytest.mark.parametrize("spec,ndim,want,local", [
    (P("data", "model"), 2, (Shard(0), Shard(1)), (3, 5)),
    (P(None, "data"), 3, (Shard(1), Replicate()), (10, 3, 10)),
    (P(("data", "model"), None), 2, (Shard(0), Shard(0)), (2, 10)),
    (P(None), 2, (Replicate(), Replicate()), (10, 10)),
    (P("model"), 1, (Replicate(), Shard(0)), (5,)),
])
def test_to_placements(spec, ndim, want, local):
    class Mesh:   # a DeviceMesh's names, all to_placements reads
        mesh_dim_names = ("data", "model")
    assert shardings.to_placements(spec, Mesh, ndim) == want
    assert shardings.local_shape((10,) * ndim, spec,
                                 {"data": 4, "model": 2}) == local


@pytest.mark.parametrize("spec,ndim", [
    (P("data", "data"), 2), (P(("model", "data")), 1), (P("pod"), 1),
    (P(None, None, None), 2)])
def test_to_placements_rejects(spec, ndim):
    class Mesh:
        mesh_dim_names = ("data", "model")
    with pytest.raises(ValueError):
        shardings.to_placements(spec, Mesh, ndim)


def test_cons_is_identity_on_one_device():
    x = torch.arange(6.0)
    assert shardings.cons(x, P("data"), shardings.SMOKE) is x
    assert shardings.cons(x, P("data"), Profile()) is x


def test_distribute_and_gather_over_gloo(tmp_path):
    """Every leaf of two smoke parameter trees (stablelm, deepseek's
    expert stacks) distributed by its spec over 2 gloo ranks under three
    meshes and gathered back bitwise (``_torch_dist.placement_worker``
    asserts it)."""
    _torch_dist.spawn(_torch_dist.placement_worker, 2, tmp_path / "rdv",
                      str(tmp_path / "done"))
    assert sorted(p.name for p in tmp_path.glob("done.*")) == [
        "done.0", "done.1"]
