"""Parity of the port's decode math with the JAX reference
(``repro.models.blocks`` / ``repro.models.lm``) at smoke sizes.

Inputs and weights are made with numpy (or by the reference's own
``init_params``) and carried to the port through
``convert.lm_params_from_numpy``.  Both sides compute in bf16 with
float32 accumulation but round at different places, so every comparison
holds at the reference tests' tolerance, rtol = atol = 3e-2; exact
token equality is no sound test (greedy logits tie in bf16).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import blocks as ref_blocks
from repro.models import lm as ref_lm
from repro.runtime.shardings import SMOKE
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.models import blocks, lm

TOL = dict(rtol=3e-2, atol=3e-2)
ARCHS = ["stablelm-12b", "qwen15_32b", "starcoder2-15b"]


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _bf16(rng, shape, scale=1.0):
    """The same bf16 values for both packages, from a numpy draw."""
    a = (rng.normal(size=shape) * scale).astype(np.float32)
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).bfloat16()


def _params(arch, seed=0):
    cfg = ref_smoke_config(arch)
    ref = ref_lm.init_params(jax.random.PRNGKey(seed), cfg)
    port = convert.lm_params_from_numpy(jax.tree.map(np.asarray, ref),
                                        get_smoke_config(arch), device="cpu")
    return cfg, ref, port


def test_configs_are_the_references():
    from repro.configs import ARCHS as REF_ARCHS
    from repro.configs import get_config as ref_get_config
    from repro_torch.configs import ARCHS as PORT_ARCHS
    from repro_torch.configs import get_config
    assert PORT_ARCHS == REF_ARCHS
    for arch in REF_ARCHS:
        for port, ref in ((get_config(arch), ref_get_config(arch)),
                          (get_smoke_config(arch), ref_smoke_config(arch))):
            assert dataclasses.asdict(port) == dataclasses.asdict(ref)
            assert (port.hd, port.padded_vocab, port.n_groups) == (
                ref.hd, ref.padded_vocab, ref.n_groups)


def test_rmsnorm_matches_reference():
    rng = np.random.default_rng(0)
    jx, tx = _bf16(rng, (3, 1, 64), 2.0)
    js, ts = _bf16(rng, (64,))
    np.testing.assert_allclose(_f32(blocks.rmsnorm(tx, ts, 1e-5)),
                               _f32(ref_blocks.rmsnorm(jx, js, 1e-5)), **TOL)


def test_rope_matches_reference():
    rng = np.random.default_rng(1)
    pos = rng.integers(0, 4096, (3, 1)).astype(np.int32)
    jsin, jcos = ref_blocks.rope_tables(jnp.asarray(pos), 16, 10000.0)
    tsin, tcos = blocks.rope_tables(torch.from_numpy(pos), 16, 10000.0)
    np.testing.assert_allclose(_f32(tsin), _f32(jsin), rtol=0, atol=1e-4)
    np.testing.assert_allclose(_f32(tcos), _f32(jcos), rtol=0, atol=1e-4)
    jx, tx = _bf16(rng, (3, 1, 2, 2, 16))
    np.testing.assert_allclose(
        _f32(blocks.apply_rope(tx, tsin, tcos)),
        _f32(ref_blocks.apply_rope(jx, jsin, jcos)), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_attn_decode_matches_reference(arch):
    cfg, ref, port = _params(arch)
    rng = np.random.default_rng(2)
    b, smax = 3, 12
    shape = (b, smax, cfg.n_kv_heads, cfg.hd)
    jk, tk = _bf16(rng, shape)
    jv, tv = _bf16(rng, shape)
    jx, tx = _bf16(rng, (b, 1, cfg.d_model))
    pos = np.array([0, 5, smax - 1], np.int32)
    jp = jax.tree.map(lambda a: a[0], ref["layers"]["0"]["attn"])
    jout, jk2, jv2 = ref_blocks.attn_decode(jp, jx, jk, jv, jnp.asarray(pos),
                                            cfg, SMOKE)
    tout, tk2, tv2 = blocks.attn_decode(port["layers"][0]["attn"], tx, tk,
                                        tv, torch.from_numpy(pos), cfg)
    np.testing.assert_allclose(_f32(tout), _f32(jout), **TOL)
    np.testing.assert_allclose(_f32(tk2), _f32(jk2), **TOL)
    np.testing.assert_allclose(_f32(tv2), _f32(jv2), **TOL)


@pytest.mark.parametrize("smax,chunk", [(16, 4), (10, 4)])
def test_chunked_decode_attention_matches_reference(smax, chunk):
    """The online-softmax branch, called directly with a small chunk;
    (10, 4) has a last chunk that the reference's dynamic_slice moves
    back to overlap the one before."""
    rng = np.random.default_rng(smax)
    b, kv, g, hd = 3, 2, 2, 16
    jq, tq = _bf16(rng, (b, 1, kv, g, hd))
    jk, tk = _bf16(rng, (b, smax, kv, hd))
    jv, tv = _bf16(rng, (b, smax, kv, hd))
    mask = np.arange(smax)[None, :] <= np.array([0, smax // 2, smax])[:, None]
    exp = ref_blocks._decode_attend_chunked(jq, jk, jv, jnp.asarray(mask),
                                            chunk=chunk)
    got = blocks._decode_attend_chunked(tq, tk, tv, torch.from_numpy(mask),
                                        chunk=chunk)
    np.testing.assert_allclose(_f32(got), _f32(exp), **TOL)


@pytest.mark.parametrize("arch", ["stablelm-12b", "starcoder2-15b"])
def test_mlp_matches_reference(arch):
    """SwiGLU (stablelm) and tanh-GELU (starcoder2)."""
    cfg, ref, port = _params(arch)
    jx, tx = _bf16(np.random.default_rng(3), (3, 1, cfg.d_model))
    jp = jax.tree.map(lambda a: a[0], ref["layers"]["0"]["mlp"])
    np.testing.assert_allclose(
        _f32(blocks.mlp_apply(port["layers"][0]["mlp"], tx, cfg)),
        _f32(ref_blocks.mlp_apply(jp, jx, cfg, SMOKE)), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_teacher_forced_match_reference(arch):
    """Several decode steps fed one token stream (teacher forcing), with
    slots at different positions, one of them running past the cache
    (the reference drops those writes): logits every step and both
    caches at the end."""
    cfg, ref, port = _params(arch, seed=1)
    b, smax, steps = 3, 8, 6
    jcache = ref_lm.init_cache(cfg, b, smax, SMOKE)
    tcache = lm.init_cache(cfg, b, smax, device="cpu")
    dec = jax.jit(lambda p, c, t, po: ref_lm.decode_step(p, c, t, po, cfg,
                                                         SMOKE))
    rng = np.random.default_rng(4)
    pos = np.array([0, 2, smax - 3], np.int32)
    for _ in range(steps):
        tok = rng.integers(0, cfg.padded_vocab, (b, 1)).astype(np.int32)
        jlog, jcache = dec(ref, jcache, jnp.asarray(tok), jnp.asarray(pos))
        tlog, tcache = lm.decode_step(port, tcache, torch.from_numpy(tok),
                                      torch.from_numpy(pos), cfg)
        assert tlog.shape == (b, 1, cfg.padded_vocab)
        np.testing.assert_allclose(_f32(tlog), _f32(jlog), **TOL)
        pos = pos + 1
    tcache = convert.lm_cache_to_numpy(tcache, cfg)
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache["0"][name],
                                   _f32(jcache["0"][name]), **TOL)


@pytest.mark.parametrize("arch", ["gemma3_27b", "mamba2_370m",
                                  "deepseek_moe_16b", "whisper_medium"])
def test_unported_decode_paths_raise(arch):
    """The four families whose decode raised ``NotImplementedError``
    until their layer kinds were ported: ``init_cache`` now builds the
    reference's cache (through ``convert.lm_cache_to_numpy``: structure,
    shapes, zeros) and one decode step from it matches the reference's
    (whisper against its zero cross rows, as both sessions decode); only
    a layer kind neither package knows raises."""
    cfg, ref, port = _params(arch, seed=2)
    b, smax = 2, 24
    tcache = lm.init_cache(cfg, b, smax, device="cpu")
    jcache = ref_lm.init_cache(cfg, b, smax, SMOKE)
    as_ref = convert.lm_cache_to_numpy(tcache, cfg)
    assert jax.tree.structure(as_ref) == jax.tree.structure(jcache)
    for a, c in zip(jax.tree.leaves(as_ref), jax.tree.leaves(jcache)):
        assert a.shape == c.shape and not a.any()
    tok = np.random.default_rng(2).integers(0, cfg.vocab, (b, 1)).astype(
        np.int32)
    pos = np.array([0, 5], np.int32)
    jlog, _ = ref_lm.decode_step(ref, jcache, jnp.asarray(tok),
                                 jnp.asarray(pos), cfg, SMOKE, unroll=True)
    tlog, _ = lm.decode_step(port, tcache, torch.from_numpy(tok),
                             torch.from_numpy(pos), cfg)
    np.testing.assert_allclose(_f32(tlog), _f32(jlog), **TOL)
    with pytest.raises(ValueError, match="unknown layer kind"):
        lm.init_cache(dataclasses.replace(cfg, pattern=("conv",)), b, smax,
                      device="cpu")


def test_init_params_shapes_and_distributions():
    """The port's own draws: the reference's shapes, bf16 storage, and
    the reference's scales (0.02 for embed/head, d**-0.5 for weights)."""
    cfg = get_smoke_config("qwen15_32b")
    gen = torch.Generator().manual_seed(0)
    port = lm.init_params(gen, cfg)
    ref = jax.eval_shape(lambda: ref_lm.init_params(jax.random.PRNGKey(0),
                                                    cfg))
    assert port["embed"].shape == ref["embed"].shape
    assert port["head"].shape == ref["head"].shape
    assert len(port["layers"]) == cfg.n_layers
    for grp in ("attn", "mlp"):
        for name, leaf in ref["layers"]["0"][grp].items():
            t = port["layers"][0][grp][name]
            assert t.shape == leaf.shape[1:] and t.dtype == torch.bfloat16
    assert abs(float(port["embed"].float().std()) - 0.02) < 2e-3
    w = port["layers"][1]["attn"]["wq"].float()
    std = cfg.d_model ** -0.5
    assert abs(float(w.std()) - std) < 0.1 * std
    assert not port["layers"][0]["attn"]["bq"].any()
    again = lm.init_params(torch.Generator().manual_seed(0), cfg)
    assert torch.equal(port["head"], again["head"])
