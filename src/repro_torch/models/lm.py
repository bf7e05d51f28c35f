"""The LM: forward pass (training), encoder, prefill and decode step
(serving) of all ten architectures, after ``repro.models.lm``.

The reference stacks each pattern slot's parameters and caches along a
leading (n_groups,) axis and scans over groups.  Here
``params["layers"]`` is a list with one parameter dict per layer and
the decode cache a list with one dict per layer, both in the
reference's layer order (:func:`layer_kinds`: group g, slot i is layer
``g * len(pattern) + i``, then the tail layers), and the trunk is a loop
over layers.  An encoder-decoder keeps its encoder's layers in
``params["enc_layers"]``.

Layer kinds: ``"attn"`` (global attention), ``"local"`` (sliding
window; banded attention over long prompts, a ring cache of
``min(window, max_seq)`` rows in decode), ``"mamba"`` (Mamba2 SSD,
``models/ssm.py``) and ``"rglru"`` (``models/rglru.py``); the MLP is
SwiGLU, GELU, MoE (``models/moe.py``) or none; whisper adds
cross-attention to the encoder's output.

Cache entries by kind: ``{"k", "v"}`` (B, rows, KV, hd) for attention
(``max_seq`` rows; a local layer's rows are its ring); ``{"state",
"conv"}`` in float32 for mamba and RG-LRU; an encoder-decoder's layers
also hold ``{"xk", "xv"}`` (B, n_frames, KV, hd), the cross-attention
rows.  The decode step updates the cache in place.

``param_specs`` and ``cache_specs`` give the spec trees of both in the
same layout (``runtime/shardings.py``): the dry run's and a mesh's
layout; the model functions themselves take no profile, since every
sharding constraint is the identity on one card.
``init_params(None, cfg, device="meta")`` builds the parameter tree's
shapes with no values.

``forward`` and ``encode`` compute in bf16 from whatever weights they
are given (the training path's float32 masters are cast at use), as the
reference's do; ``prefill`` and ``decode_step`` compute in the
parameters' own dtype: bf16 for the serving path's weights, float32 for
a check of the math free of bf16 rounding.
"""

from __future__ import annotations

from functools import partial

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models import blocks, moe, rglru, ssm
from repro_torch.models.blocks import C, MetaDraws, _cast, _normal, rmsnorm
from repro_torch.models.config import ModelConfig
from repro_torch.runtime.shardings import P, Profile
from repro_torch.tree import tree_map

KINDS = ("attn", "local", "mamba", "rglru")


def layer_kinds(cfg: ModelConfig) -> list[str]:
    """The kind of each layer, in the reference's order: the groups'
    pattern, then the tail."""
    for kind in cfg.pattern:
        if kind not in KINDS:
            raise ValueError(f"{cfg.name}: unknown layer kind {kind!r}")
    return list(cfg.pattern) * cfg.n_groups + list(cfg.tail_pattern)


# ------------------------------------------------------------------ params
def _layer_init(gen, kind: str, cfg: ModelConfig, dtype, cross: bool):
    ones = lambda: torch.ones((cfg.d_model,), dtype=dtype, device=gen.device)
    p = {"ln1": ones()}
    if kind in ("attn", "local"):
        p["attn"] = blocks.init_attn(gen, cfg, dtype)
    elif kind == "mamba":
        p["mixer"] = ssm.init_mamba(gen, cfg, dtype)
    else:
        p["mixer"] = rglru.init_rglru(gen, cfg, dtype)
    if cross:
        p["ln_x"] = ones()
        p["xattn"] = blocks.init_attn(gen, cfg, dtype, cross=True)
    if kind != "mamba" and cfg.mlp != "none":
        p["ln2"] = ones()
        if cfg.n_experts:
            p["moe"] = moe.init_moe(gen, cfg, dtype)
        else:
            p["mlp"] = blocks.init_mlp(gen, cfg, dtype=dtype)
    return p


def init_params(generator: torch.Generator | None, cfg: ModelConfig,
                dtype=C, device=None) -> dict:
    """Random parameters with the reference's shapes and distributions,
    drawn from ``generator`` on its device and stored in ``dtype``: bf16
    for serving, float32 for the master weights of training.  The values
    are the port's own: a torch generator does not reproduce the
    reference's threefry draws.  ``device="meta"`` builds the same tree
    on the ``meta`` device with no generator: shapes and dtypes, no
    values (the dry run's parameters)."""
    if device is not None:
        if torch.device(device).type != "meta":
            raise ValueError(f"device= builds on 'meta' only, got {device!r}"
                             "; draw on another device through its "
                             "generator")
        generator = MetaDraws()
    d = cfg.d_model
    params = {"embed": _normal(generator, (cfg.padded_vocab, d), 0.02,
                               dtype),
              "final_norm": torch.ones((d,), dtype=dtype,
                                       device=generator.device)}
    if not cfg.tie_embeddings:
        params["head"] = _normal(generator, (d, cfg.padded_vocab), 0.02,
                                 dtype)
    cross = cfg.encoder_layers > 0
    params["layers"] = [_layer_init(generator, kind, cfg, dtype, cross)
                        for kind in layer_kinds(cfg)]
    if cross:
        params["enc_layers"] = [
            _layer_init(generator, "attn", cfg, dtype, cross=False)
            for _ in range(cfg.encoder_layers)]
        params["enc_norm"] = torch.ones((d,), dtype=dtype,
                                        device=generator.device)
    return params


def _slot_specs(kind: str, cfg: ModelConfig, prof: Profile,
                cross: bool) -> dict:
    """The spec tree of one layer's weights (:func:`_layer_init`)."""
    p = {"ln1": prof.vector()}
    if kind in ("attn", "local"):
        p["attn"] = blocks.attn_specs(cfg, prof)
    elif kind == "mamba":
        p["mixer"] = ssm.mamba_specs(cfg, prof)
    else:
        p["mixer"] = rglru.rglru_specs(cfg, prof)
    if cross:
        p["ln_x"] = prof.vector()
        p["xattn"] = blocks.attn_specs(cfg, prof, cross=True)
    if kind != "mamba" and cfg.mlp != "none":
        p["ln2"] = prof.vector()
        p["moe" if cfg.n_experts else "mlp"] = (
            moe.moe_specs(cfg, prof) if cfg.n_experts
            else blocks.mlp_specs(cfg, prof))
    return p


def param_specs(cfg: ModelConfig, prof: Profile) -> dict:
    """The spec tree of :func:`init_params`, in its layout: one spec dict
    per layer under ``layers`` (the reference stacks each pattern slot
    and adds a leading ``None`` for the group axis)."""
    cross = cfg.encoder_layers > 0
    specs = {"embed": prof.embed(), "final_norm": prof.vector()}
    if not cfg.tie_embeddings:
        specs["head"] = prof.head()
    specs["layers"] = [_slot_specs(kind, cfg, prof, cross)
                       for kind in layer_kinds(cfg)]
    if cross:
        specs["enc_layers"] = [_slot_specs("attn", cfg, prof, False)
                               for _ in range(cfg.encoder_layers)]
        specs["enc_norm"] = prof.vector()
    return specs


def params_to(params, device, dtype=None):
    """A copy of a parameter or cache tree (dicts and lists of tensors)
    on ``device``, cast to ``dtype`` where one is given."""
    return tree_map(lambda t: t.to(device=device, dtype=dtype), params)


# ----------------------------------------------------------------- forward
def ring_rows(s: int, window: int, device=None) -> torch.Tensor:
    """The positions a local layer's ring holds after s tokens: slot r
    the last position p < s with p % window == r, for the
    ``min(window, s)`` slots (a prompt shorter than the window gives a
    ring of s rows, as the reference's ``_ring_gather`` does)."""
    r = torch.arange(min(window, s), device=device)
    return (s - 1) - ((s - 1 - r) % window)


def ring_positions(pos, window: int, cache_len: int) -> torch.Tensor:
    """(B, cache_len): the absolute position each ring slot r holds at
    decode position ``pos`` (B,): the largest p <= pos with
    p % window == r (negative: empty)."""
    r = torch.arange(cache_len, device=pos.device)
    return pos[:, None] - ((pos[:, None] - r[None]) % window)


def _cache_rows(k, v, kind: str, cfg: ModelConfig, max_seq: int) -> dict:
    """A prefill's K/V rows as the decode cache holds them: a local
    layer's ring, or a global layer's rows padded to ``max_seq``."""
    s = k.shape[1]
    if kind == "local":
        idx = ring_rows(s, cfg.window or s, k.device)
        return {"k": k[:, idx], "v": v[:, idx]}
    if max_seq > s:
        pad = (0, 0, 0, 0, 0, max_seq - s)
        k, v = F.pad(k, pad), F.pad(v, pad)
    return {"k": k, "v": v}


def _sublayer(p, x, *, kind, cfg: ModelConfig, positions, enc, causal,
              chunk, collect, max_seq):
    """One layer over x (B, S, D), its weights cast to x's dtype here (so
    a rematerialised layer recasts them instead of keeping them).
    Returns (x, the layer's decode cache or None)."""
    p = _cast(p, x.dtype)
    new_c = None
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    if kind in ("attn", "local"):
        out = blocks.attn_apply(p["attn"], h, cfg, kind=kind, causal=causal,
                                positions=positions, chunk=chunk,
                                return_kv=collect)
        if collect:
            h, k, v = out
            new_c = _cache_rows(k, v, kind, cfg, max_seq)
        else:
            h = out
    elif kind == "mamba":
        out = ssm.mamba_apply(p["mixer"], h, cfg, return_state=collect)
        h, new_c = out if collect else (out, None)
    else:
        out = rglru.rglru_apply(p["mixer"], h, cfg, return_state=collect)
        h, new_c = out if collect else (out, None)
    x = x + h
    if "xattn" in p and enc is not None:
        h = rmsnorm(x, p["ln_x"], cfg.norm_eps)
        out = blocks.attn_apply(p["xattn"], h, cfg, causal=False,
                                positions=positions, kv_src=enc,
                                use_rope=False, return_kv=collect)
        if collect:
            h, xk, xv = out
            new_c = dict(new_c, xk=xk, xv=xv)
        else:
            h = out
        x = x + h
    if "mlp" in p or "moe" in p:
        h = rmsnorm(x, p["ln2"], cfg.norm_eps)
        x = x + (moe.moe_apply(p["moe"], h, cfg) if "moe" in p
                 else blocks.mlp_apply(p["mlp"], h, cfg))
    return x, new_c


def trunk(params, x, cfg: ModelConfig, *, positions, enc=None, causal=True,
          chunk=0, remat=False, collect=False, max_seq=0,
          layers_key="layers"):
    """The layers of ``params[layers_key]`` over x (B, S, D) (the
    encoder's are all ``"attn"``).  ``remat`` recomputes each layer in
    the backward pass instead of keeping its activations
    (``torch.utils.checkpoint``, the reference's ``jax.checkpoint``).
    With ``collect`` returns (x, the decode cache as a list)."""
    layers = params[layers_key]
    kinds = layer_kinds(cfg) if layers_key == "layers" else ["attn"] * len(
        layers)
    caches = []
    for p, kind in zip(layers, kinds, strict=True):
        layer = partial(_sublayer, kind=kind, cfg=cfg, positions=positions,
                        enc=enc, causal=causal, chunk=chunk, collect=collect,
                        max_seq=max_seq)
        if remat:
            x, c = checkpoint(layer, p, x, use_reentrant=False)
        else:
            x, c = layer(p, x)
        caches.append(c)
    return (x, caches) if collect else x


def _positions(b: int, s: int, device):
    return torch.arange(s, device=device)[None].expand(b, s)


def _logits(params, x, cfg: ModelConfig):
    x = rmsnorm(x, params["final_norm"].to(x.dtype), cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["head"]
    return x @ head.to(x.dtype)


def _embed(params, tokens, prefix_embeds, dtype):
    x = F.embedding(tokens, params["embed"].to(dtype))
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(dtype), x], dim=1)
    return x


def encode(params, frames, cfg: ModelConfig, *, remat=False):
    """The whisper encoder over stub frame embeddings (B, F, D):
    bidirectional attention layers, then ``enc_norm``.  It computes in
    ``C`` (bf16) whatever its weights' dtype and returns that dtype, as
    the reference's does (the training path's float32 masters are cast
    at use); ``remat`` as in :func:`trunk`."""
    b, f, _ = frames.shape
    x = trunk(params, frames.to(C), cfg, positions=_positions(
        b, f, frames.device), causal=False, remat=remat,
        layers_key="enc_layers")
    return rmsnorm(x, params["enc_norm"].to(x.dtype), cfg.norm_eps)


def forward(params, tokens, cfg: ModelConfig, *, prefix_embeds=None,
            enc=None, chunk=0, remat=False):
    """tokens (B, S_t) int -> logits (B, S_total, padded_vocab) in bf16.

    ``prefix_embeds`` (B, Np, D): stub frontend output (vision patches),
    prepended to the token embeddings (internvl2); ``enc`` (B, F, D):
    the encoder's output for cross-attention (whisper).  ``chunk`` as in
    :func:`repro_torch.models.blocks.attend_full`."""
    x = _embed(params, tokens, prefix_embeds, C)
    b, s, _ = x.shape
    x = trunk(params, x, cfg, positions=_positions(b, s, x.device), enc=enc,
              chunk=chunk, remat=remat)
    return _logits(params, x, cfg)


def prefill(params, tokens, cfg: ModelConfig, *, max_seq: int = 0,
            prefix_embeds=None, enc=None, chunk=0):
    """Process a whole prompt in the parameters' dtype; return the last
    position's logits (B, 1, padded_vocab) and the decode cache.

    ``max_seq``: the global layers' cache rows (at least the prompt's
    length; the rest for decoding).  A local layer caches its ring, a
    mamba or RG-LRU layer its state and conv rows, a cross-attention
    layer the K/V of ``enc``."""
    x = _embed(params, tokens, prefix_embeds, params["embed"].dtype)
    b, s, _ = x.shape
    x, cache = trunk(params, x, cfg, positions=_positions(b, s, x.device),
                     enc=enc, chunk=chunk, collect=True,
                     max_seq=max(max_seq, s))
    return _logits(params, x[:, -1:], cfg), cache


# ------------------------------------------------------------------- cache
def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device="cuda",
               dtype=C) -> list:
    """Decode cache of zeros, one dict per layer: K/V rows in ``dtype``
    (``max_seq`` rows, a local layer ``min(window, max_seq)``), the
    recurrent states in float32; with an encoder also zero
    cross-attention rows for ``n_frames`` frames."""
    kv, hd = cfg.n_kv_heads, cfg.hd
    zeros = lambda rows: torch.zeros((batch, rows, kv, hd), dtype=dtype,
                                     device=device)
    cache = []
    for kind in layer_kinds(cfg):
        if kind in ("attn", "local"):
            rows = (min(cfg.window or max_seq, max_seq) if kind == "local"
                    else max_seq)
            c = {"k": zeros(rows), "v": zeros(rows)}
        elif kind == "mamba":
            c = ssm.mamba_init_cache(cfg, batch, device)
        else:
            c = rglru.rglru_init_cache(cfg, batch, device)
        if cfg.encoder_layers:
            c.update(xk=zeros(cfg.n_frames), xv=zeros(cfg.n_frames))
        cache.append(c)
    return cache


def cache_specs(cfg: ModelConfig, prof: Profile, model_size: int) -> list:
    """The spec tree of :func:`init_cache`: one dict per layer.  K/V rows
    by ``prof.cache_kv`` (heads over the model axis where they divide
    it, else the rows), recurrent states over the batch."""
    kvspec = prof.cache_kv(cfg.n_kv_heads, model_size)
    specs = []
    for kind in layer_kinds(cfg):
        if kind in ("attn", "local"):
            c = {"k": kvspec, "v": kvspec}
        elif kind == "mamba":
            c = {"state": P(prof.da, prof.ma, None, None),
                 "conv": P(prof.da, None, None)}
        else:
            c = {"state": P(prof.da, prof.ma),
                 "conv": P(prof.da, None, prof.ma)}
        if cfg.encoder_layers:
            c.update(xk=kvspec, xv=kvspec)
        specs.append(c)
    return specs


# ------------------------------------------------------------------ decode
def _local_decode(p, x, c, pos, cfg: ModelConfig):
    """One-token decode of a local layer over its ring: the new K/V rows
    go to slot ``pos % ring length`` in place, and the query sees the
    slots whose position is within the window."""
    b = x.shape[0]
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q, knew, vnew = blocks.decode_qkv(p, x, pos, cfg)
    w = c["k"].shape[1]
    slot = pos % w
    blocks.write_rows(c["k"], knew[:, 0], slot)
    blocks.write_rows(c["v"], vnew[:, 0], slot)
    held = ring_positions(pos, cfg.window, w)
    mask = ((held >= 0) & (held <= pos[:, None])
            & (held > pos[:, None] - cfg.window))
    out = blocks._sdpa(q, c["k"].to(q.dtype), c["v"].to(q.dtype),
                       mask[:, None])
    return out.reshape(b, 1, h * hd) @ p["wo"]


def decode_layer(p, x, c, kind: str, pos, cfg: ModelConfig):
    """One layer of a decode step in the parameters' dtype: x (B, 1, D)
    -> the layer's output, its cache ``c`` updated in place."""
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    if kind == "attn":
        h, _, _ = blocks.attn_decode(p["attn"], h, c["k"], c["v"], pos, cfg)
    elif kind == "local":
        h = _local_decode(p["attn"], h, c, pos, cfg)
    else:
        step = ssm.mamba_decode if kind == "mamba" else rglru.rglru_decode
        h, new = step(p["mixer"], h, c, cfg)
        c.update(new)
    x = x + h
    if "xattn" in p:
        h = rmsnorm(x, p["ln_x"], cfg.norm_eps)
        h, _, _ = blocks.attn_decode(p["xattn"], h, c["xk"], c["xv"], pos,
                                     cfg, cross=True, use_rope=False)
        x = x + h
    if "mlp" in p or "moe" in p:
        h = rmsnorm(x, p["ln2"], cfg.norm_eps)
        x = x + (moe.moe_apply(p["moe"], h, cfg) if "moe" in p
                 else blocks.mlp_apply(p["mlp"], h, cfg))
    return x


def decode_step(params, cache, tokens, pos, cfg: ModelConfig):
    """One decode step in the parameters' dtype.  tokens (B, 1) int, pos
    (B,) int (position of the new token).  Returns (logits (B, 1,
    padded_vocab), cache), the cache updated in place."""
    x = params["embed"][tokens]                              # (B, 1, D)
    for p, kind, c in zip(params["layers"], layer_kinds(cfg), cache,
                          strict=True):
        x = decode_layer(p, x, c, kind, pos, cfg)
    return _logits(params, x, cfg), cache
