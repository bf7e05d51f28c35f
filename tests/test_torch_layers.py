"""Parity of the port's layer kinds with the JAX reference at smoke
sizes: the attention forms (windowed, non-causal, banded; K/V rows,
cross-attention sources and no RoPE), the local and cross decode
attention, Mamba2 SSD (``repro.models.ssm``), RG-LRU
(``repro.models.rglru``), the dense MoE path (``repro.models.moe``), the
whisper encoder and the forward pass of the six architectures they
bring.

Inputs are numpy draws from a seed and weights the reference's own
``init_params``, carried to the port by ``convert``.  Both sides compute
in bf16 with float32 accumulation and round at different places, so the
math holds at the reference tests' rtol = atol = 3e-2; the MoE routing
(expert indices, slot positions, the kept mask) and the dispatched rows
are held bitwise, as is the recurrence's doubling scan against a loop
in float64.
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
from repro.models import moe as ref_moe
from repro.models import rglru as ref_rglru
from repro.models import ssm as ref_ssm
from repro.runtime.shardings import SMOKE
from repro_torch import convert
from repro_torch.configs import ARCHS, get_smoke_config
from repro_torch.models import blocks, lm, moe, rglru, ssm

from _torch_moe import record_routing, rows_routed_alike

TOL = dict(rtol=3e-2, atol=3e-2)
NEW_ARCHS = ["gemma3_27b", "recurrentgemma_9b", "mamba2_370m",
             "deepseek_moe_16b", "arctic_480b", "whisper_medium"]


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _bf16(rng, shape, scale=1.0):
    """The same bf16 values for both packages, from a numpy draw."""
    a = (rng.normal(size=shape) * scale).astype(np.float32)
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).bfloat16()


def _params(arch, seed=0):
    """The reference's parameters and the port's bf16 copy of them."""
    cfg = ref_smoke_config(arch)
    ref = ref_lm.init_params(jax.random.PRNGKey(seed), cfg)
    port = convert.lm_params_from_numpy(jax.tree.map(np.asarray, ref),
                                        get_smoke_config(arch), device="cpu")
    return cfg, ref, port


def _slot(ref, i, name, g=0):
    """Group g's slot i sub-tree ``name`` of the reference's parameters
    (the port's layer ``g * len(pattern) + i``)."""
    return jax.tree.map(lambda a: a[g], ref["layers"][str(i)][name])


# --------------------------------------------------------------- attention
@pytest.mark.parametrize("s,window", [(32, 8), (48, 16), (16, 16)])
def test_attend_window_banded_matches_reference(s, window):
    """(16, 16) is one chunk: no previous chunk anywhere."""
    rng = np.random.default_rng(s + window)
    qkv = [_bf16(rng, (2, s, 4, 16)) for _ in range(3)]
    exp = ref_blocks.attend_window_banded(*[j for j, _ in qkv], SMOKE,
                                          window=window)
    got = blocks.attend_window_banded(*[t for _, t in qkv], window=window)
    np.testing.assert_allclose(_f32(got), _f32(exp), **TOL)


def test_banded_equals_windowed_full_form():
    """The banded form computes the windowed causal attention the full
    form masks; the port's two forms agree."""
    rng = np.random.default_rng(7)
    q, k, v = (_bf16(rng, (2, 32, 4, 16))[1] for _ in range(3))
    pos = torch.arange(32)[None].expand(2, 32)
    full = blocks.attend_full(q, k, v, pos, pos, window=8)
    np.testing.assert_allclose(
        _f32(blocks.attend_window_banded(q, k, v, window=8)), _f32(full),
        **TOL)


def test_banded_mask_matches_reference():
    """The in-band mask, first chunk included, bitwise."""
    w, nc = 4, 3
    qpos = np.arange(w)[:, None] + w
    kpos = np.arange(2 * w)[None, :]
    m = (kpos <= qpos) & (kpos > qpos - w)
    exp = np.where((np.arange(nc) == 0)[:, None, None], (m & (kpos >= w))[None],
                   m[None])
    np.testing.assert_array_equal(blocks.banded_mask(nc, w, "cpu").numpy(),
                                  exp)
    with pytest.raises(ValueError, match="multiple of window"):
        blocks.attend_window_banded(*(torch.zeros((1, 6, 1, 4)),) * 3,
                                    window=4)


@pytest.mark.parametrize("causal,window,chunk", [
    (True, 8, 0), (False, 0, 0), (False, 8, 0), (True, 8, 8)])
def test_attend_full_masks_match_reference(causal, window, chunk):
    rng = np.random.default_rng(int(causal) + window + chunk)
    qkv = [_bf16(rng, (2, 24 if not chunk else 16, 4, 16)) for _ in range(3)]
    s = qkv[0][1].shape[1]
    pos = np.broadcast_to(np.arange(s)[None], (2, s)).astype(np.int32)
    exp = ref_blocks.attend_full(*[j for j, _ in qkv], jnp.asarray(pos),
                                 jnp.asarray(pos), SMOKE, causal=causal,
                                 window=window, chunk=chunk)
    tpos = torch.from_numpy(pos)
    got = blocks.attend_full(*[t for _, t in qkv], tpos, tpos, causal=causal,
                             window=window, chunk=chunk)
    np.testing.assert_allclose(_f32(got), _f32(exp), **TOL)


@pytest.mark.parametrize("kind,causal,s", [
    ("local", True, 17), ("local", True, 16), ("local", True, 32),
    ("local", True, 48), ("local", False, 32), ("attn", True, 32)])
def test_uses_banded_is_the_references_condition(kind, causal, s):
    cfg = get_smoke_config("gemma3_27b")
    exp = (kind == "local" and causal and bool(cfg.window)
           and s > cfg.window and s % cfg.window == 0)
    assert blocks.uses_banded(kind, causal, s, cfg) is exp


@pytest.mark.parametrize("kind,s", [("local", 32), ("local", 24),
                                    ("local", 8), ("attn", 24)])
def test_attn_apply_return_kv_matches_reference(kind, s):
    """gemma3's widths (GQA 4 over 2): the banded form at 32, the
    windowed full form at 24 and 8, a global layer; out and the K/V
    rows after RoPE, before the repeat."""
    cfg, ref, port = _params("gemma3_27b")
    slot = 0 if kind == "local" else 5
    jp = _slot(ref, slot, "attn")
    jx, tx = _bf16(np.random.default_rng(s), (2, s, cfg.d_model))
    jout, jk, jv = ref_blocks.attn_apply(jp, jx, cfg, SMOKE, kind=kind,
                                         return_kv=True)
    tout, tk, tv = blocks.attn_apply(port["layers"][slot]["attn"], tx, cfg,
                                     kind=kind, return_kv=True)
    assert tk.shape == (2, s, cfg.n_kv_heads, cfg.hd)
    for got, exp in ((tout, jout), (tk, jk), (tv, jv)):
        np.testing.assert_allclose(_f32(got), _f32(exp), **TOL)


def test_cross_attention_apply_matches_reference():
    """whisper's cross layer: a source of other length, not causal, no
    RoPE, its K/V rows returned (the cross cache)."""
    cfg, ref, port = _params("whisper_medium")
    rng = np.random.default_rng(11)
    jx, tx = _bf16(rng, (2, 8, cfg.d_model))
    je, te = _bf16(rng, (2, cfg.n_frames, cfg.d_model))
    jout, jk, jv = ref_blocks.attn_apply(
        _slot(ref, 0, "xattn"), jx, cfg, SMOKE, causal=False, kv_src=je,
        use_rope=False, return_kv=True)
    tout, tk, tv = blocks.attn_apply(
        port["layers"][0]["xattn"], tx, cfg, causal=False, kv_src=te,
        use_rope=False, return_kv=True)
    assert tk.shape == (2, cfg.n_frames, cfg.n_kv_heads, cfg.hd)
    for got, exp in ((tout, jout), (tk, jk), (tv, jv)):
        np.testing.assert_allclose(_f32(got), _f32(exp), **TOL)


@pytest.mark.parametrize("kind,cross", [("local", False), ("attn", True)])
def test_attn_decode_local_and_cross_match_reference(kind, cross):
    """``attn_decode`` with the window mask over a flat cache, and the
    cross form (no write, all-true mask, no RoPE)."""
    arch = "gemma3_27b" if kind == "local" else "whisper_medium"
    cfg, ref, port = _params(arch)
    rng = np.random.default_rng(5)
    b, smax = 3, 40
    jk, tk = _bf16(rng, (b, smax, cfg.n_kv_heads, cfg.hd))
    jv, tv = _bf16(rng, (b, smax, cfg.n_kv_heads, cfg.hd))
    jx, tx = _bf16(rng, (b, 1, cfg.d_model))
    pos = np.array([3, 20, 39], np.int32)
    name = "xattn" if cross else "attn"
    jout, jk2, jv2 = ref_blocks.attn_decode(
        _slot(ref, 0, name), jx, jk, jv, jnp.asarray(pos), cfg, SMOKE,
        kind=kind, cross=cross, use_rope=not cross)
    tout, tk2, tv2 = blocks.attn_decode(
        port["layers"][0][name], tx, tk, tv, torch.from_numpy(pos), cfg,
        kind=kind, cross=cross, use_rope=not cross)
    np.testing.assert_allclose(_f32(tout), _f32(jout), **TOL)
    np.testing.assert_allclose(_f32(tk2), _f32(jk2), **TOL)
    np.testing.assert_allclose(_f32(tv2), _f32(jv2), **TOL)
    if cross:
        assert torch.equal(tk2, tk)


# -------------------------------------------------------------------- mamba
@pytest.mark.parametrize("s", [16, 13, 5])
def test_mamba_apply_with_state_matches_reference(s):
    """16: two whole chunks of 8; 13: padded to 16 (dt = 0 on the pad);
    5: one chunk of 5."""
    cfg, ref, port = _params("mamba2_370m", seed=s)
    jx, tx = _bf16(np.random.default_rng(s), (2, s, cfg.d_model))
    jout, jst = ref_ssm.mamba_apply(_slot(ref, 0, "mixer"), jx, cfg, SMOKE,
                                    return_state=True)
    tout, tst = ssm.mamba_apply(port["layers"][0]["mixer"], tx, cfg,
                                return_state=True)
    np.testing.assert_allclose(_f32(tout), _f32(jout), **TOL)
    for name in ("state", "conv"):
        assert tst[name].dtype == torch.float32
        assert tst[name].shape == jst[name].shape
        np.testing.assert_allclose(_f32(tst[name]), _f32(jst[name]), **TOL)


def test_mamba_decode_steps_match_reference():
    """Five steps from a prefilled state, the cache carried by each
    package and compared every step."""
    cfg, ref, port = _params("mamba2_370m", seed=3)
    rng = np.random.default_rng(3)
    jp, tp = _slot(ref, 0, "mixer", g=1), port["layers"][1]["mixer"]
    jx, tx = _bf16(rng, (2, 9, cfg.d_model))
    _, jc = ref_ssm.mamba_apply(jp, jx, cfg, SMOKE, return_state=True)
    tc = {k: torch.from_numpy(np.array(a, np.float32)) for k, a in
          jc.items()}
    for _ in range(5):
        jx, tx = _bf16(rng, (2, 1, cfg.d_model))
        jout, jc = ref_ssm.mamba_decode(jp, jx, jc, cfg, SMOKE)
        tout, tc = ssm.mamba_decode(tp, tx, tc, cfg)
        np.testing.assert_allclose(_f32(tout), _f32(jout), **TOL)
        for name in ("state", "conv"):
            np.testing.assert_allclose(_f32(tc[name]), _f32(jc[name]),
                                       **TOL)


@pytest.mark.parametrize("arch,fn", [("mamba2_370m", "mamba"),
                                     ("recurrentgemma_9b", "rglru")])
def test_short_prompt_conv_cache_raises(arch, fn):
    """A prompt shorter than the conv cache's rows: the reference keeps
    fewer rows (the next decode step then fails on the shape); the port
    raises."""
    cfg, ref, port = _params(arch)
    jx, tx = _bf16(np.random.default_rng(0), (1, 2, cfg.d_model))
    ref_fn = ref_ssm.mamba_apply if fn == "mamba" else ref_rglru.rglru_apply
    _, jst = ref_fn(_slot(ref, 0, "mixer"), jx, cfg, SMOKE,
                    return_state=True)
    assert jst["conv"].shape[1] < 3
    port_fn = ssm.mamba_apply if fn == "mamba" else rglru.rglru_apply
    with pytest.raises(ValueError, match="shorter than the conv cache"):
        port_fn(port["layers"][0]["mixer"], tx, cfg, return_state=True)
    assert port_fn(port["layers"][0]["mixer"], tx, cfg).shape == tx.shape


# -------------------------------------------------------------------- rglru
@pytest.mark.parametrize("s", [1, 3, 16, 37])
def test_linear_scan_equals_the_recurrence(s):
    """The doubling scan against the loop over positions in float64, at
    lengths that are and are not powers of two."""
    rng = np.random.default_rng(s)
    a = rng.uniform(0.0, 1.0, (2, s, 5))
    x = rng.normal(size=(2, s, 5))
    h, exp = np.zeros((2, 5)), np.zeros((2, s, 5))
    for t in range(s):
        h = a[:, t] * h + x[:, t]
        exp[:, t] = h
    got = rglru.linear_scan(torch.from_numpy(a), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), exp, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("s", [16, 37])
def test_rglru_apply_with_state_matches_reference(s):
    cfg, ref, port = _params("recurrentgemma_9b", seed=s)
    rng = np.random.default_rng(s)
    jp, tp = _slot(ref, 0, "mixer"), port["layers"][0]["mixer"]
    for name in ("w_r", "b_r", "w_i", "b_i"):   # gates away from zero
        g = rng.normal(size=tp[name].shape).astype(np.float32)
        jp[name], tp[name] = jnp.asarray(g), torch.from_numpy(g).bfloat16()
    jx, tx = _bf16(rng, (2, s, cfg.d_model))
    jout, jst = ref_rglru.rglru_apply(jp, jx, cfg, SMOKE, return_state=True)
    tout, tst = rglru.rglru_apply(tp, tx, cfg, return_state=True)
    np.testing.assert_allclose(_f32(tout), _f32(jout), **TOL)
    for name in ("state", "conv"):
        assert tst[name].shape == jst[name].shape
        np.testing.assert_allclose(_f32(tst[name]), _f32(jst[name]), **TOL)


def test_rglru_decode_steps_match_reference():
    cfg, ref, port = _params("recurrentgemma_9b", seed=2)
    rng = np.random.default_rng(2)
    jp, tp = _slot(ref, 1, "mixer"), port["layers"][1]["mixer"]
    jx, tx = _bf16(rng, (3, 6, cfg.d_model))
    _, jc = ref_rglru.rglru_apply(jp, jx, cfg, SMOKE, return_state=True)
    tc = {k: torch.from_numpy(np.array(a, np.float32)) for k, a in
          jc.items()}
    for _ in range(5):
        jx, tx = _bf16(rng, (3, 1, cfg.d_model))
        jout, jc = ref_rglru.rglru_decode(jp, jx, jc, cfg, SMOKE)
        tout, tc = rglru.rglru_decode(tp, tx, tc, cfg)
        np.testing.assert_allclose(_f32(tout), _f32(jout), **TOL)
        for name in ("state", "conv"):
            np.testing.assert_allclose(_f32(tc[name]), _f32(jc[name]),
                                       **TOL)


# ---------------------------------------------------------------------- moe
def _routing(cfg, jp, tp, jx, tx):
    """Both packages' routing of x (T, D): the reference's
    ``_route_and_dispatch`` and the port's route / positions /
    dispatch."""
    e, k = cfg.n_experts, cfg.top_k
    jcast = ref_blocks._cast(jp)
    j_xe, j_fe, j_pos, j_keep, j_gate = ref_moe._route_and_dispatch(
        jx, jcast["router"], e, k, cfg.capacity_factor)
    gate, eidx = moe.route(tx, tp["router"], k)
    cap = moe.capacity(tx.shape[0], k, e, cfg.capacity_factor)
    flat_e = eidx.reshape(-1)
    pos, keep = moe.dispatch_positions(flat_e, e, cap)
    x_e = moe.dispatch(tx, flat_e, k, e, cap)
    return ((j_xe, j_fe, j_pos, j_keep, j_gate),
            (x_e, flat_e, pos, keep, gate))


def _assert_routing_bitwise(ref_r, port_r):
    (j_xe, j_fe, j_pos, j_keep, j_gate), (x_e, flat_e, pos, keep, gate) = \
        ref_r, port_r
    np.testing.assert_array_equal(flat_e.numpy(), np.asarray(j_fe))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(j_pos))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(j_keep))
    assert x_e.shape == j_xe.shape
    np.testing.assert_array_equal(_f32(x_e), _f32(j_xe))
    np.testing.assert_allclose(gate.numpy(), np.asarray(j_gate), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("arch,router", [
    ("deepseek_moe_16b", "random"), ("arctic_480b", "random"),
    ("deepseek_moe_16b", "zero"), ("arctic_480b", "paired")])
def test_moe_routing_is_bitwise_the_references(arch, router):
    """Expert indices, slot positions, the kept mask and the dispatched
    rows, bitwise.  ``zero``: every probability ties, so every token
    takes the lowest k indices; ``paired``: columns repeat in pairs, so
    each tie is between two indices, the lower first."""
    cfg, ref, port = _params(arch)
    cfg = dataclasses.replace(cfg, capacity_factor=1.25)
    jp, tp = _slot(ref, 0, "moe"), port["layers"][0]["moe"]
    if router != "random":
        r = np.asarray(jp["router"])
        r = np.zeros_like(r) if router == "zero" else np.repeat(
            r[:, ::2], 2, axis=1)
        jp["router"], tp["router"] = jnp.asarray(r), torch.from_numpy(
            r).bfloat16()
    jx, tx = _bf16(np.random.default_rng(9), (40, cfg.d_model))
    ref_r, port_r = _routing(cfg, jp, tp, jx, tx)
    _assert_routing_bitwise(ref_r, port_r)
    if router == "zero":
        assert (port_r[1].reshape(40, -1) == torch.arange(cfg.top_k)).all()
        assert not port_r[3].all()          # capacity drops the rest


def test_moe_decode_batch_capacity_drops_like_the_reference():
    """deepseek-moe-16b's own routing numbers at 8 decode slots: capacity
    max(1, int(8 * 6 / 64 * 1.25)) = 1, so an expert keeps only its
    earliest assignment in (token, k) order."""
    from repro_torch.configs import get_config
    full = get_config("deepseek_moe_16b")
    assert moe.capacity(8, full.top_k, full.n_experts,
                        full.capacity_factor) == 1
    cfg, ref, port = _params("deepseek_moe_16b", seed=4)
    cfg = dataclasses.replace(cfg, capacity_factor=1.25)   # cap = 3 at 8
    jp, tp = _slot(ref, 0, "moe"), port["layers"][0]["moe"]
    jx, tx = _bf16(np.random.default_rng(4), (8, 1, cfg.d_model))
    ref_r, port_r = _routing(cfg, jp, tp, jx.reshape(8, -1),
                             tx.reshape(8, -1))
    _assert_routing_bitwise(ref_r, port_r)
    assert not port_r[3].all()
    np.testing.assert_allclose(
        _f32(moe.moe_apply(tp, tx, cfg)),
        _f32(ref_moe.moe_apply(jp, jx, cfg, SMOKE)), **TOL)


@pytest.mark.parametrize("arch", ["deepseek_moe_16b", "arctic_480b"])
def test_moe_apply_matches_reference(arch):
    """deepseek: routed + 2 shared experts; arctic: routed + the dense
    residual FFN, at its default capacity (drops included)."""
    cfg, ref, port = _params(arch, seed=1)
    jx, tx = _bf16(np.random.default_rng(1), (2, 12, cfg.d_model))
    tp = port["layers"][1]["moe"]
    assert ("shared" in tp) == bool(cfg.n_shared_experts)
    assert ("residual" in tp) == cfg.dense_residual
    np.testing.assert_allclose(
        _f32(moe.moe_apply(tp, tx, cfg)),
        _f32(ref_moe.moe_apply(_slot(ref, 0, "moe", g=1), jx, cfg, SMOKE)),
        **TOL)


def _skewed_experts(rng, t, k, pool, e):
    """(T*k,) int64: k distinct experts a token from ``pool`` (all of the
    E when None), drawn with weights 1 / (i + 1), so that the first few
    pass their capacity."""
    pool = np.arange(e) if pool is None else np.asarray(pool)
    w = 1.0 / np.arange(1, len(pool) + 1)
    return torch.from_numpy(np.stack([
        rng.choice(pool, k, replace=False, p=w / w.sum())
        for _ in range(t)]).reshape(-1).astype(np.int64))


@pytest.mark.parametrize("shared_sort", [False, True])
@pytest.mark.parametrize("t,k,e,cap,pool", [
    (50, 1, 8, None, [5]),                  # every assignment to one expert
    (40, 2, 16, None, [1, 4, 9, 15]),       # experts with no assignment
    (37, 3, 10, 7, None),                   # T*k = 111, not a power of two
    (8, 6, 64, None, None),                 # decode: T*k = 48, capacity 1
    (300, 2, 128, None, None),              # arctic's E and k
    (512, 6, 64, None, None)],              # deepseek's, 3,072 assignments
    ids=["one_expert", "empty_experts", "odd_tk", "decode", "arctic",
         "deepseek"])
def test_dispatch_matches_a_loop(t, k, e, cap, pool, shared_sort):
    """``dispatch_positions`` and ``dispatch`` against a loop over the
    assignments: each one's rank among the earlier ones to its expert,
    and expert by expert the tokens of its first ``cap`` assignments, in
    (token, k) order, zeros after them.  Capacity as the layer takes it
    (cf 1.25) where ``cap`` is None; with or without the sort passed in
    as ``_routed`` passes it."""
    cap = moe.capacity(t, k, e, 1.25) if cap is None else cap
    flat_e = _skewed_experts(np.random.default_rng(t * e), t, k, pool, e)
    xt = torch.arange(1, t + 1, dtype=torch.float32)[:, None].expand(
        t, 3).contiguous()
    by_e = moe.sort_by_expert(flat_e, e) if shared_sort else None
    pos, keep = moe.dispatch_positions(flat_e, e, cap, by_e)
    x_e = moe.dispatch(xt, flat_e, k, e, cap, by_e)

    seen = [0] * e
    exp_pos = []
    exp_x = torch.zeros(e, cap, 3)
    for i, ex in enumerate(flat_e.tolist()):
        exp_pos.append(seen[ex])
        if seen[ex] < cap:
            exp_x[ex, seen[ex]] = xt[i // k]
        seen[ex] += 1
    assert pos.dtype == torch.int64 and keep.dtype == torch.bool
    assert pos.tolist() == exp_pos
    assert keep.tolist() == [p < cap for p in exp_pos]
    assert torch.equal(x_e, exp_x)
    if pool is not None:
        assert min(seen) == 0               # some expert has no assignment
    if e == 64:
        assert max(seen) > cap              # capacity drops assignments


# --------------------------------------------------------- encoder, forward
def test_encode_matches_reference():
    cfg, ref, port = _params("whisper_medium", seed=2)
    frames = np.random.default_rng(2).normal(
        size=(2, cfg.n_frames, cfg.d_model)).astype(np.float32)
    exp = ref_lm.encode(ref, jnp.asarray(frames), cfg, SMOKE)
    got = lm.encode(port, torch.from_numpy(frames), cfg)
    assert got.dtype == torch.bfloat16 and got.shape == exp.shape
    np.testing.assert_allclose(_f32(got), _f32(exp), **TOL)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_forward_matches_reference(arch):
    """Logits of the whole model from the port's float32 masters (cast
    to bf16 at use, as training holds them), against the reference's
    unrolled trunk, op by op: its scan over groups compiles each group
    whole and rounds elsewhere (at arctic-smoke the scan and the
    unrolled trunk themselves route a token apart, max |diff| 0.198).
    whisper with its encoder's output.  A MoE model's rows with a token
    the packages routed apart on a router tie are left out
    (``_torch_moe``)."""
    cfg = ref_smoke_config(arch)
    ref = ref_lm.init_params(jax.random.PRNGKey(1), cfg)
    port = convert.lm_params_from_numpy(jax.tree.map(np.asarray, ref),
                                        get_smoke_config(arch), device="cpu",
                                        dtype=torch.float32)
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, cfg.vocab, (2, 33)).astype(np.int32)
    jenc = tenc = None
    if cfg.encoder_layers:
        frames = rng.normal(size=(2, cfg.n_frames, cfg.d_model)).astype(
            np.float32)
        jenc = ref_lm.encode(ref, jnp.asarray(frames), cfg, SMOKE)
        tenc = torch.from_numpy(np.asarray(jenc, np.float32)).bfloat16()
    with record_routing() as rec:
        exp = ref_lm.forward(ref, jnp.asarray(tokens), cfg, SMOKE, enc=jenc,
                             unroll=True)
        got = lm.forward(port, torch.from_numpy(tokens), cfg, enc=tenc)
    assert got.dtype == torch.bfloat16 and got.shape == exp.shape
    rows = rows_routed_alike(rec, 2)
    assert rows.any() and len(rec["port"]) == (cfg.n_layers
                                               if cfg.n_experts else 0)
    np.testing.assert_allclose(_f32(got)[rows], _f32(exp)[rows], **TOL)


def _shapes(tree, path=()):
    """(path, shape, dtype) of every tensor of a parameter tree."""
    if isinstance(tree, dict):
        return [x for k in tree for x in _shapes(tree[k], path + (k,))]
    if isinstance(tree, list):
        return [x for i, t in enumerate(tree) for x in _shapes(t, path + (i,))]
    return [(path, tuple(tree.shape), tree.dtype)]


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_shapes_match_reference(arch):
    """The port's own draws in the reference's shapes, in the
    reference's layer order (groups, then the tail), for all ten."""
    cfg = get_smoke_config(arch)
    port = lm.init_params(torch.Generator().manual_seed(0), cfg)
    ref = jax.eval_shape(lambda: ref_lm.init_params(jax.random.PRNGKey(0),
                                                    ref_smoke_config(arch)))
    ref = jax.tree.map(lambda a: np.zeros(a.shape, np.float32), ref)
    assert len(port["layers"]) == cfg.n_layers == len(lm.layer_kinds(cfg))
    assert sorted(_shapes(port), key=repr) == sorted(_shapes(
        convert.lm_params_from_numpy(ref, cfg, device="cpu")), key=repr)
