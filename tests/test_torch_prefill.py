"""Parity of the port's prefill, decode cache and serving with the JAX
reference (``repro.models.lm``, ``repro.serve.session``) for all ten
architectures at smoke sizes.

Weights come from the reference's own ``init_params`` and cross as numpy
(``convert.lm_params_from_numpy``), caches cross both ways
(``convert.lm_cache_from_numpy`` / ``lm_cache_to_numpy``), inputs are
numpy draws from a seed.  The model math holds at the reference tests'
rtol = atol = 3e-2.  The reference runs unrolled, op by op (its scan
over groups compiles each group whole and rounds elsewhere); a MoE
model's rows with a token the two packages routed apart on a router tie
are left out of the logits (``_torch_moe``).  Exact: the ring's gather
indices and slot positions, and the cache layout's round trip.

A prefill's cache accumulates each layer's rounding into the next
layer's rows, so its rows are held layer by layer: every layer gets the
reference's own input, and its output and cache rows are compared.
"""

import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.configs import ARCHS
from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import lm as ref_lm
from repro.runtime.shardings import SMOKE
from repro.serve.session import Session as RefSession
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.models import lm
from repro_torch.serve.session import Session

from _torch_moe import record_routing, rows_routed_alike

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = dict(rtol=3e-2, atol=3e-2)
NEW_ARCHS = ["gemma3_27b", "recurrentgemma_9b", "mamba2_370m",
             "deepseek_moe_16b", "arctic_480b", "whisper_medium"]


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _setup(arch, seed=0, b=2, s=16):
    """Config, reference and port parameters, and the inputs of a
    prompt of s tokens (s + 8 drawn) with whisper's encoder output and
    internvl2's patches, as (reference kwargs, port kwargs)."""
    cfg = ref_smoke_config(arch)
    ref = ref_lm.init_params(jax.random.PRNGKey(seed), cfg)
    port = convert.lm_params_from_numpy(jax.tree.map(np.asarray, ref),
                                        get_smoke_config(arch), device="cpu")
    rng = np.random.default_rng(seed + 100)
    tokens = rng.integers(0, cfg.vocab, (b, s + 8)).astype(np.int32)
    jkw, tkw = {}, {}
    if cfg.encoder_layers:
        frames = rng.normal(size=(b, cfg.n_frames, cfg.d_model)).astype(
            np.float32)
        jkw["enc"] = ref_lm.encode(ref, jnp.asarray(frames), cfg, SMOKE)
        tkw["enc"] = lm.encode(port, torch.from_numpy(frames), cfg)
    if cfg.n_patches:
        patches = rng.normal(size=(b, cfg.n_patches, cfg.d_model)).astype(
            np.float32)
        jkw["prefix_embeds"] = jnp.asarray(patches)
        tkw["prefix_embeds"] = torch.from_numpy(patches)
    return cfg, ref, port, tokens, jkw, tkw


def _ref_layers(ref, cfg):
    """(kind, reference slot parameters) of every layer in order."""
    out = [(kind, jax.tree.map(lambda a, g=g: a[g], ref["layers"][str(i)]))
           for g in range(cfg.n_groups) for i, kind in enumerate(cfg.pattern)]
    return out + [(kind, ref["tail"][str(i)])
                  for i, kind in enumerate(cfg.tail_pattern)]


# -------------------------------------------------------------------- ring
@pytest.mark.parametrize("s,window", [(8, 16), (16, 16), (24, 16), (32, 16),
                                      (37, 16), (1, 4), (2048, 2048),
                                      (4096, 2048)])
def test_ring_rows_are_the_references_gather(s, window):
    """The positions ``_ring_gather`` puts in each ring slot, bitwise;
    below the window the ring is the prompt's s rows."""
    pos = jnp.arange(s, dtype=jnp.int32).reshape(1, s, 1, 1)
    exp, _ = ref_lm._ring_gather(pos, pos, window)
    np.testing.assert_array_equal(lm.ring_rows(s, window).numpy(),
                                  np.asarray(exp)[0, :, 0, 0])


@pytest.mark.parametrize("window,cache_len", [(16, 16), (16, 8), (4, 4)])
def test_ring_positions_are_the_references(window, cache_len):
    pos = np.array([0, 3, 7, 15, 16, 17, 40, 1000], np.int32)
    exp = ref_lm._ring_mask_positions(jnp.asarray(pos), window, cache_len)
    got = lm.ring_positions(torch.from_numpy(pos), window, cache_len)
    np.testing.assert_array_equal(got.numpy(), np.asarray(exp))


# ------------------------------------------------------------------ layout
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_layout_round_trip(arch):
    """The reference's prefill cache through the port's layout and back,
    bitwise (bf16 rows are exact in float32); the port's ``init_cache``
    in the reference's ``init_cache`` structure, shapes and zeros."""
    cfg, ref, port, tokens, jkw, _ = _setup(arch)
    _, jcache = ref_lm.prefill(ref, jnp.asarray(tokens[:, :16]), cfg, SMOKE,
                               max_seq=24, unroll=True, **jkw)
    jnp_cache = jax.tree.map(lambda a: np.asarray(a, np.float32), jcache)
    tcache = convert.lm_cache_from_numpy(jnp_cache, cfg, device="cpu")
    assert len(tcache) == cfg.n_layers
    back = convert.lm_cache_to_numpy(tcache, cfg)
    assert jax.tree.structure(back) == jax.tree.structure(jnp_cache)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jnp_cache)):
        assert a.dtype == np.float32 and np.array_equal(a, b)

    fresh = lm.init_cache(cfg, 3, 24, device="cpu")
    ref_fresh = ref_lm.init_cache(cfg, 3, 24, SMOKE)
    as_ref = convert.lm_cache_to_numpy(fresh, cfg)
    assert jax.tree.structure(as_ref) == jax.tree.structure(ref_fresh)
    for a, b in zip(jax.tree.leaves(as_ref), jax.tree.leaves(ref_fresh)):
        assert a.shape == b.shape and not a.any()
    again = convert.lm_cache_from_numpy(as_ref, cfg, device="cpu")
    for a, b in zip(jax.tree.leaves(again), jax.tree.leaves(fresh)):
        assert a.dtype == b.dtype and torch.equal(a, b)


# ----------------------------------------------------------------- prefill
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_match_reference(arch):
    """The last position's logits; the cache's structure and shapes are
    the reference's (through ``lm_cache_to_numpy``), and the first
    layer's rows, whose input is the embedding both share, match."""
    cfg, ref, port, tokens, jkw, tkw = _setup(arch, seed=1)
    with record_routing() as rec:
        jlog, jcache = ref_lm.prefill(ref, jnp.asarray(tokens[:, :16]), cfg,
                                      SMOKE, max_seq=24, unroll=True, **jkw)
        tlog, tcache = lm.prefill(port, torch.from_numpy(tokens[:, :16]),
                                  cfg, max_seq=24, **tkw)
    assert tlog.shape == jlog.shape == (2, 1, cfg.padded_vocab)
    rows = rows_routed_alike(rec, 2)
    assert rows.any()
    np.testing.assert_allclose(_f32(tlog)[rows], _f32(jlog)[rows], **TOL)
    got = convert.lm_cache_to_numpy(tcache, cfg)
    assert jax.tree.structure(got) == jax.tree.structure(jcache)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jcache)):
        assert a.shape == b.shape
    first = got["0"] if cfg.n_groups else got["tail"]["0"]
    exp = jax.tree.map(np.asarray, jcache["0"])
    for name, a in first.items():
        np.testing.assert_allclose(a[0], _f32(exp[name][0]), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_layers_cache_rows_like_the_reference(arch):
    """Each layer's prefill (``collect``) from the reference's own input
    to that layer: the output and the cache rows it keeps (the padded
    global rows, the local ring, the mamba and RG-LRU states and conv
    rows, the cross-attention rows)."""
    cfg, ref, port, tokens, jkw, tkw = _setup(arch, seed=2)
    emb = ref["embed"].astype(jnp.bfloat16)
    x = emb[jnp.asarray(tokens[:, :16])]
    if "prefix_embeds" in jkw:
        x = jnp.concatenate([jkw["prefix_embeds"].astype(jnp.bfloat16), x], 1)
    b, s, _ = x.shape
    jpos = jnp.broadcast_to(jnp.arange(s)[None], (b, s))
    tpos = torch.arange(s)[None].expand(b, s)
    tenc = None if "enc" not in jkw else torch.from_numpy(
        np.asarray(jkw["enc"], np.float32)).bfloat16()
    for layer, (kind, pslot) in enumerate(_ref_layers(ref, cfg)):
        with record_routing() as rec:
            jx, jc = ref_lm._sublayer(pslot, kind, x, cfg, SMOKE,
                                      positions=jpos, enc=jkw.get("enc"),
                                      collect=True, max_seq=s + 8)
            tx, tc = lm._sublayer(
                port["layers"][layer], torch.from_numpy(
                    np.asarray(x, np.float32)).bfloat16(), kind=kind,
                cfg=cfg, positions=tpos, enc=tenc, causal=True, chunk=0,
                collect=True, max_seq=s + 8)
        rows = rows_routed_alike(rec, b)
        np.testing.assert_allclose(_f32(tx)[rows], _f32(jx)[rows], **TOL)
        if "xk" in jc:
            jc = dict(jc["self"], xk=jc["xk"], xv=jc["xv"])
        assert set(tc) == set(jc)
        for name in jc:
            assert tc[name].shape == jc[name].shape, (layer, name)
            assert tc[name].dtype == (torch.float32 if kind in ("mamba",
                                                                "rglru")
                                      else torch.bfloat16)
            np.testing.assert_allclose(_f32(tc[name]), _f32(jc[name]),
                                       err_msg=f"layer {layer} {name}",
                                       **TOL)
        x = jx


# ------------------------------------------------------------------ decode
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_after_prefill_match_reference(arch):
    """Teacher-forced decode steps from one cache: the reference's own
    prefill cache, handed to the port through ``lm_cache_from_numpy``,
    so both start equal; logits every step, and at the end the first
    layer's cache (a local ring, an RG-LRU or mamba state, global rows
    and whisper's cross rows), whose input is the embedding both share.
    Deeper layers' rows carry each step's bf16 drift through the layers
    above them (a few elements of gemma3-smoke's layers 4-7 past 3e-2
    after six steps) and are held through the logits."""
    cfg, ref, port, tokens, jkw, _ = _setup(arch, seed=3)
    _, jcache = ref_lm.prefill(ref, jnp.asarray(tokens[:, :16]), cfg, SMOKE,
                               max_seq=24 + cfg.n_patches, unroll=True,
                               **jkw)
    tcache = convert.lm_cache_from_numpy(
        jax.tree.map(np.asarray, jcache), cfg, device="cpu")
    pos = np.full((2,), 16 + cfg.n_patches, np.int32)
    for i in range(16, 22):
        tok = tokens[:, i:i + 1]
        with record_routing() as rec:
            jlog, jcache = ref_lm.decode_step(ref, jcache, jnp.asarray(tok),
                                              jnp.asarray(pos), cfg, SMOKE,
                                              unroll=True)
            tlog, tcache = lm.decode_step(port, tcache, torch.from_numpy(tok),
                                          torch.from_numpy(pos), cfg)
        rows = rows_routed_alike(rec, 2)
        assert rows.any()
        np.testing.assert_allclose(_f32(tlog)[rows], _f32(jlog)[rows], **TOL)
        pos = pos + 1
    exp = convert.lm_cache_from_numpy(jax.tree.map(np.asarray, jcache), cfg,
                                      device="cpu")[0]
    assert tcache[0].keys() == exp.keys()
    for name, t in tcache[0].items():
        np.testing.assert_allclose(_f32(t), _f32(exp[name]), err_msg=name,
                                   **TOL)


@pytest.mark.parametrize("arch", ["stablelm_12b", "gemma3_27b",
                                  "mamba2_370m", "recurrentgemma_9b",
                                  "deepseek_moe_16b", "whisper_medium"])
def test_prefill_then_decode_matches_forward(arch):
    """The reference's own consistency check (tests/test_arch_smoke.py)
    on the port: decoding token s after ``prefill`` of s tokens gives
    ``forward``'s logits at position s (s = 16 = gemma3's and
    recurrentgemma's window).  whisper with its encoder's output.  Not
    arctic: its decode step at 2 slots has capacity 1 per expert and
    drops what ``forward`` keeps (the reference's rule)."""
    cfg, ref, port, tokens, _, tkw = _setup(arch, seed=4)
    s = 16
    t = torch.from_numpy(tokens)
    want = lm.forward(port, t[:, :s + 1], cfg, **tkw)[:, s]
    _, cache = lm.prefill(port, t[:, :s], cfg, max_seq=s + 8, **tkw)
    got, _ = lm.decode_step(port, cache, t[:, s:s + 1],
                            torch.full((2,), s, dtype=torch.int32), cfg)
    np.testing.assert_allclose(_f32(got[:, 0]), _f32(want), **TOL)


@pytest.mark.parametrize("arch", ["gemma3_27b", "recurrentgemma_9b"])
def test_short_prompt_ring_mirrors_reference(arch):
    """A prompt of half the window: the reference's ring holds the
    prompt's 8 rows, and the decode step then takes the ring's length
    from that cache and writes token 8 over position 0, so prefill ->
    decode leaves ``forward`` (max |diff| 0.27 for gemma3-smoke and 0.10
    for recurrentgemma-smoke at their seed; ROADMAP queue 3).  The port
    keeps the same ring and the same decode: it is held to the
    reference's decode here, not to ``forward``."""
    cfg, ref, port, tokens, _, _ = _setup(arch, seed=5)
    s = cfg.window // 2
    _, jcache = ref_lm.prefill(ref, jnp.asarray(tokens[:, :s]), cfg, SMOKE,
                               max_seq=s + 8, unroll=True)
    _, tcache = lm.prefill(port, torch.from_numpy(tokens[:, :s]), cfg,
                           max_seq=s + 8)
    local = [c for c, kind in zip(tcache, lm.layer_kinds(cfg))
             if kind == "local"]
    assert local and all(c["k"].shape[1] == s for c in local)
    pos = np.full((2,), s, np.int32)
    for i in range(s, s + 4):
        tok = tokens[:, i:i + 1]
        jlog, jcache = ref_lm.decode_step(ref, jcache, jnp.asarray(tok),
                                          jnp.asarray(pos), cfg, SMOKE,
                                          unroll=True)
        tlog, tcache = lm.decode_step(port, tcache, torch.from_numpy(tok),
                                      torch.from_numpy(pos), cfg)
        np.testing.assert_allclose(_f32(tlog), _f32(jlog), **TOL)
        pos = pos + 1


# ----------------------------------------------------------------- serving
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_session_with_reference_weights_runs_the_same_commits(arch):
    """The port's ``Session`` over the reference's weights (after
    tests/test_torch_serve.py): each step's logits agree with the
    reference session's within tolerance (rows routed alike), and
    feeding the port's logits to both keeps the committed state bitwise
    equal.  whisper decodes against the zero cross cache both sessions
    build."""
    cfg = ref_smoke_config(arch)
    params = ref_lm.init_params(jax.random.PRNGKey(3), cfg)
    tparams = convert.lm_params_from_numpy(jax.tree.map(np.asarray, params),
                                           cfg, device="cpu")
    ref = RefSession(cfg, params, n_slots=2, max_seq=32)
    ref._decode = lambda p, c, t, po: ref_lm.decode_step(p, c, t, po, cfg,
                                                         SMOKE, unroll=True)
    port = Session(cfg, tparams, n_slots=2, max_seq=32, device="cpu")
    port_decode, ref_decode = port._decode, ref._decode
    fed, ref_logits = [], []

    def port_recording(*args):
        out = port_decode(*args)
        fed.append(out[0].float().numpy())
        return out

    def ref_fed(*args):
        logits, cache = ref_decode(*args)
        ref_logits.append(np.asarray(logits, np.float32))
        return jnp.asarray(fed[-1], jnp.bfloat16), cache

    port._decode, ref._decode = port_recording, ref_fed
    for s in (0, 1):
        port.add_request(s, 3 + 7 * s)
        ref.add_request(s, 3 + 7 * s)
    for _ in range(6):
        with record_routing() as rec:
            port_tokens = port.step()
            ref_tokens = np.asarray(ref.step())
        np.testing.assert_array_equal(port_tokens, ref_tokens)
        rows = rows_routed_alike(rec, 2)
        assert rows.any()
        np.testing.assert_allclose(fed[-1][rows], ref_logits[-1][rows], **TOL)
    assert port.fingerprint() == ref.fingerprint()
    assert np.asarray(ref.page_versions).any()


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_replicas_with_reversed_arrivals_are_identical(arch):
    cfg = get_smoke_config(arch)
    params = lm.init_params(torch.Generator().manual_seed(6), cfg)
    requests = [(s, 3 + 7 * s) for s in range(3)]
    runs = []
    for order in (requests, requests[::-1]):
        sess = Session(cfg, params, n_slots=3, max_seq=32, device="cpu")
        for slot, tok in order:
            sess.add_request(slot, tok)
        runs.append((sess.generate(8), sess.fingerprint()))
    (t1, f1), (t2, f2) = runs
    np.testing.assert_array_equal(t1, t2)
    assert f1 == f2


@pytest.mark.parametrize("arch", ["mamba2-370m", "recurrentgemma-9b",
                                  "whisper-medium"])
def test_launcher_serves_the_new_families_on_cpu(arch):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
         "--device", "cpu", "--replica-check"],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert "replica (reversed arrivals) identical: True" in out.stdout
    assert f"arch={get_smoke_config(arch).name}" in out.stdout
