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
layout.  ``init_params(None, cfg, device="meta")`` builds the parameter
tree's shapes with no values.

``forward``, ``prefill``, ``decode_step`` and ``trunk`` take a profile
(``SMOKE`` by default: one process).  On a profile with a mesh every
rank runs the call SPMD on its own shards (:func:`local_params`,
:func:`init_cache` with ``prof``), as the reference's ``cons``
constraints lay them out (``shardings.Place``):

- the residual stream between sublayers is the rank's block: its batch
  rows over the data axes and, where ``seq_shard`` and the sequence
  divides the model axis, its sequence block (``act_btd``); norms run
  on the block;
- attention and the dense MLP are tensor-parallel (``blocks.attn_apply``
  and ``mlp_apply`` with the rank's place): the sequence gathered at the
  entry (``act_gathered``), the rank's heads or hidden columns, the
  partial outputs reduce-scattered into the block;
- the embedding is looked up by vocab block: each rank looks up its
  batch rows' tokens that fall in its block of ``embed``, the other
  rows zero, and the ranks' rows are summed over the model axis into
  its block of the residual stream (one nonzero row a token, so the sum
  is exact); the logits are computed by vocab block over the model axis
  (``act_btv``) from the rank's block of ``head`` and gathered whole on
  every rank, where the loss is computed whole;
- the mamba2 mixer splits its heads over the model axis
  (``models/ssm.py``), the RG-LRU mixer its width (``models/rglru.py``)
  and cross-attention its heads, as self-attention does, reading the
  rank's batch rows of the whole encoder output; the encoder's layers
  run on the rank's block of the frames (:func:`encode`);
- the MoE layer runs its expert parallelism (``models/moe.py``) on the
  rank's block;
- a rank holds each parameter and decode-cache leaf as its spec cuts it
  (:func:`local_params` by :func:`param_specs`, :func:`local_cache` by
  :func:`cache_specs`), the one layout the dry run reads, ``embed`` and
  ``head`` by vocab block.

Under ``pure_dp`` (the model axis as one more data axis) the batch
splits over every rank and nothing is tensor-parallel: each weight's
FSDP shard is gathered whole at use over the data axes and the model
axis, ``embed`` and ``head`` whole over the model axis, and every
sublayer runs its dense body on the rank's rows.  A MoE layer is
refused there: its expert specs name the model axis twice, as the
reference's do.

Every leaf a rank holds whole gets its whole gradient, summed over the
ranks whose tokens used it, and a shard its shard's, all through the
fixed-ring ordered reduction, so a train step is bitwise the same
whatever the ranks' timing.  Each function has one body for both: off
a mesh its place is ``shardings.ALONE``, whose blocks are the whole and
whose steps across ranks are the identity.  At one rank each call is
the dense path bit for bit.

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
from repro_torch.models.blocks import C, MetaDraws, _normal, rmsnorm
from repro_torch.models.config import ModelConfig
from repro_torch.runtime.shardings import (ALONE, SMOKE, P, Place, Profile,
                                           block, local_tree, place_of)
from repro_torch.runtime.spans import span
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


def on_mesh(prof: Profile) -> bool:
    """Whether ``prof`` runs the model SPMD over a mesh."""
    return prof.enabled and prof.mesh is not None


def local_params(params, cfg: ModelConfig, prof: Profile) -> dict:
    """The parameter tree (or a tree of its shape, an AdamW moment) a
    rank holds under ``prof``: each leaf its shard by
    :func:`param_specs` (``shardings.local_shard``; the tensor itself
    where its spec cuts nothing); ``params`` itself where the profile
    has no mesh."""
    if not on_mesh(prof):
        return params
    return local_tree(params, param_specs(cfg, prof), prof.mesh)


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


def _cache_rows(k, v, kind: str, cfg: ModelConfig, max_seq: int,
                place: Place = ALONE) -> dict:
    """A prefill's K/V rows as the decode cache holds them: a local
    layer's ring, or a global layer's rows padded to ``max_seq``.  On a
    mesh the rank's shard: the rows of its K/V heads where they split
    over the model axis, else its block of the rows (a local layer's
    ring padded to its decode length ``min(window, max_seq)`` first)."""
    s = k.shape[1]
    if kind == "local":
        idx = ring_rows(s, cfg.window or s, k.device)
        c = {"k": k[:, idx], "v": v[:, idx]}
    elif max_seq > s:
        pad = (0, 0, 0, 0, 0, max_seq - s)
        c = {"k": F.pad(k, pad), "v": F.pad(v, pad)}
    else:
        c = {"k": k, "v": v}
    if blocks.kv_split(cfg, place):
        return c
    rows = (min(cfg.window or max_seq, max_seq) if kind == "local"
            else c["k"].shape[1])
    if rows % place.n_model:
        raise ValueError(f"a cache of {rows} rows does not split over the "
                         f"model axis of {place.n_model} ranks")
    return {name: block(F.pad(t, (0, 0, 0, 0, 0, rows - t.shape[1])), 1,
                        place.m, place.n_model).contiguous()
            for name, t in c.items()}


def _cross_rows(k, v, cfg: ModelConfig, place: Place) -> dict:
    """A prefill's cross-attention K/V rows (B_b, F, KV', hd) as the
    decode cache holds them: the rank's heads where the K/V heads split
    over the model axis, else its block of the frames."""
    if blocks.kv_split(cfg, place):
        return {"xk": k, "xv": v}
    if k.shape[1] % place.n_model:
        raise ValueError(f"{k.shape[1]} frames do not split over the model "
                         f"axis of {place.n_model} ranks")
    return {n: block(t, 1, place.m, place.n_model).contiguous()
            for n, t in (("xk", k), ("xv", v))}


def _sublayer(p, x, *, kind, cfg: ModelConfig, prof: Profile = SMOKE,
              place: Place = ALONE, positions, enc, causal, chunk, collect,
              max_seq):
    """One layer over x (B, S, D), its weights cast to x's dtype at use
    (so a rematerialised layer recasts them instead of keeping them).
    On a mesh (module docstring) x is the rank's block (B_b, S_b, D),
    ``positions`` (B_b, S) its batch rows' and ``enc`` its batch rows of
    the encoder's output (B_b, F, D).  Returns (x, the layer's decode
    cache, on a mesh the rank's shard, or None)."""
    dt = x.dtype

    def norm(name, t):
        scale = place.shared(p[name], model=place.seq_split).to(dt)
        return rmsnorm(t, scale, cfg.norm_eps)

    new_c = None
    h = norm("ln1", x)
    if kind in ("attn", "local"):
        out = blocks.attn_apply(p["attn"], h, cfg, kind=kind, causal=causal,
                                positions=positions, chunk=chunk,
                                return_kv=collect, place=place)
        if collect:
            h, k, v = out
            new_c = _cache_rows(k, v, kind, cfg, max_seq, place)
        else:
            h = out
    else:
        mixer = ssm.mamba_apply if kind == "mamba" else rglru.rglru_apply
        out = mixer(p["mixer"], h, cfg, return_state=collect, place=place)
        h, new_c = out if collect else (out, None)
    x = x + h
    if "xattn" in p and enc is not None:
        h = norm("ln_x", x)
        out = blocks.attn_apply(p["xattn"], h, cfg, causal=False,
                                kv_src=enc, use_rope=False,
                                return_kv=collect, place=place)
        if collect:
            out, xk, xv = out
            new_c = dict(new_c, **_cross_rows(xk, xv, cfg, place))
        x = x + out
    if "mlp" in p or "moe" in p:
        h = norm("ln2", x)
        x = x + (moe.moe_apply(p["moe"], h, cfg, prof, place) if "moe" in p
                 else blocks.mlp_apply(p["mlp"], h, cfg, place))
    return x, new_c


def trunk(params, x, cfg: ModelConfig, prof: Profile = SMOKE, *, positions,
          enc=None, causal=True, chunk=0, remat=False, collect=False,
          max_seq=0, layers_key="layers", place: Place = ALONE):
    """The layers of ``params[layers_key]`` over x (B, S, D) (the
    encoder's are all ``"attn"``).  ``remat`` recomputes each layer in
    the backward pass instead of keeping its activations
    (``torch.utils.checkpoint``, the reference's ``jax.checkpoint``).
    With ``collect`` returns (x, the decode cache as a list).  With the
    ``place`` of a rank on a mesh x is its block (B_b, S_b, D) and
    ``positions`` (B_b, S) its batch rows' (module docstring)."""
    layers = params[layers_key]
    kinds = layer_kinds(cfg) if layers_key == "layers" else ["attn"] * len(
        layers)
    caches = []
    for p, kind in zip(layers, kinds, strict=True):
        layer = partial(_sublayer, kind=kind, cfg=cfg, prof=prof,
                        place=place, positions=positions, enc=enc,
                        causal=causal, chunk=chunk, collect=collect,
                        max_seq=max_seq)
        if remat:
            x, c = checkpoint(layer, p, x, use_reentrant=False)
        else:
            x, c = layer(p, x)
        caches.append(c)
    return (x, caches) if collect else x


def _positions(b: int, s: int, device):
    return torch.arange(s, device=device)[None].expand(b, s)


def place_len(tokens, prefix_embeds) -> int:
    """The sequence's length: the tokens' after the prefix's."""
    return tokens.shape[1] + (0 if prefix_embeds is None
                              else prefix_embeds.shape[1])


def _vocab_leaf(params, name: str, cfg: ModelConfig, place: Place):
    """``embed`` (V_b, D) or the head (D, V_b; ``embed`` transposed where
    the embeddings are tied) as the rank computes with it
    (``Place.vocab_block``): its vocab block, whose first id is
    ``place.m * V_b``."""
    key = "embed" if name == "embed" or cfg.tie_embeddings else "head"
    dim = 0 if key == "embed" else 1
    w = params[key]
    if w.shape[dim] * place.n_vocab != cfg.padded_vocab:
        raise ValueError(f"{key} of {w.shape[dim]} vocab entries where the "
                         f"rank holds {cfg.padded_vocab // place.n_vocab}: "
                         f"carry the weights across with lm.local_params")
    w = place.vocab_block(w, dim)
    return w.T if key != name else w


def _logits(params, x, cfg: ModelConfig, place: Place = ALONE):
    """The final norm and the head over x (B, S, D).  On a mesh x is the
    rank's block (B_b, S_b, D): the rank computes its vocab block of the
    whole sequence's logits, gathered into the whole (B, S, V) on every
    rank."""
    with span("pot.logits"):
        scale = place.shared(params["final_norm"], model=place.seq_split)
        x = place.enter(rmsnorm(x, scale.to(x.dtype), cfg.norm_eps))
        head = _vocab_leaf(params, "head", cfg, place)
        return place.gather_logits(x @ head.to(x.dtype))


def _lookup(params, tokens, cfg: ModelConfig, dtype, place: Place):
    """The embedding rows of the rank's batch rows of ``tokens`` that fall
    in its vocab block, the other rows zero (masked: no index leaves the
    block)."""
    table = _vocab_leaf(params, "embed", cfg, place).to(dtype)
    ids = place.batch_block(tokens) - place.m * table.shape[0]
    mine = (ids >= 0) & (ids < table.shape[0])
    rows = F.embedding(torch.where(mine, ids, 0), table)
    return torch.where(mine[..., None], rows, 0)


def _embed(params, tokens, prefix_embeds, cfg: ModelConfig, dtype,
           place: Place):
    """The embeddings of ``tokens`` (after ``prefix_embeds``): the rank's
    block of them.  The ranks' looked-up rows are summed over the model
    axis into the block (``Place.leave``, whose adjoint gathers the
    sequence's cotangent); the prefix enters the sum on the model
    group's first rank only, so it is added to zeros."""
    x = _lookup(params, tokens, cfg, dtype, place)
    if prefix_embeds is not None:
        pre = place.batch_block(prefix_embeds).to(dtype)
        x = torch.cat([pre if place.m == 0 else torch.zeros_like(pre), x],
                      dim=1)
    return place.leave(x)


def encode(params, frames, cfg: ModelConfig, prof: Profile = SMOKE, *,
           remat=False):
    """The whisper encoder over stub frame embeddings (B, F, D):
    bidirectional attention layers, then ``enc_norm``.  It computes in
    ``C`` (bf16) whatever its weights' dtype and returns that dtype, as
    the reference's does (the training path's float32 masters are cast
    at use); ``remat`` as in :func:`trunk`.  On a profile with a mesh
    ``frames`` is whole on every rank, the layers run on the rank's
    block of it (module docstring) and the result is the rank's batch
    rows with every frame (B_b, F, D), gathered over the model axis
    since cross-attention reads them all: what :func:`forward` and
    :func:`prefill` take as ``enc`` there."""
    b, f, _ = frames.shape
    place = place_of(prof, (b, f))
    x = trunk(params, place.take_block(frames.to(C)), cfg, prof,
              positions=place.batch_block(_positions(b, f, frames.device)),
              causal=False, remat=remat, layers_key="enc_layers",
              place=place)
    scale = place.shared(params["enc_norm"], model=place.seq_split)
    return place.enter(rmsnorm(x, scale.to(x.dtype), cfg.norm_eps))


def _enc_rows(enc, b: int, place: Place):
    """``enc`` checked to be the rank's batch rows of the encoder's
    output (:func:`encode` on the same profile)."""
    if enc is not None and enc.shape[0] != b // place.n_batch:
        raise ValueError(f"enc of {enc.shape[0]} rows where the rank holds "
                         f"{b // place.n_batch} of {b}: on a mesh pass "
                         f"lm.encode's output on the same profile")
    return enc


def forward(params, tokens, cfg: ModelConfig, prof: Profile = SMOKE, *,
            prefix_embeds=None, enc=None, chunk=0, remat=False):
    """tokens (B, S_t) int -> logits (B, S_total, padded_vocab) in bf16.

    ``prefix_embeds`` (B, Np, D): stub frontend output (vision patches),
    prepended to the token embeddings (internvl2); ``enc`` (B, F, D):
    the encoder's output for cross-attention (whisper; on a mesh the
    rank's rows, :func:`encode`).  ``chunk`` as in
    :func:`repro_torch.models.blocks.attend_full`."""
    b, s = tokens.shape[0], place_len(tokens, prefix_embeds)
    place = place_of(prof, (b, s))
    x = _embed(params, tokens, prefix_embeds, cfg, C, place)
    positions = place.batch_block(_positions(b, s, x.device))
    x = trunk(params, x, cfg, prof, positions=positions,
              enc=_enc_rows(enc, b, place),
              chunk=chunk, remat=remat, place=place)
    return _logits(params, x, cfg, place)


def prefill(params, tokens, cfg: ModelConfig, prof: Profile = SMOKE, *,
            max_seq: int = 0, prefix_embeds=None, enc=None, chunk=0):
    """Process a whole prompt in the parameters' dtype; return the last
    position's logits (B, 1, padded_vocab) and the decode cache.

    ``max_seq``: the global layers' cache rows (at least the prompt's
    length; the rest for decoding).  A local layer caches its ring, a
    mamba or RG-LRU layer its state and conv rows, a cross-attention
    layer the K/V of ``enc``."""
    b, s = tokens.shape[0], place_len(tokens, prefix_embeds)
    place = place_of(prof, (b, s))
    x = _embed(params, tokens, prefix_embeds, cfg, params["embed"].dtype,
               place)
    positions = place.batch_block(_positions(b, s, x.device))
    x, cache = trunk(params, x, cfg, prof, positions=positions,
                     enc=_enc_rows(enc, b, place),
                     chunk=chunk, collect=True, max_seq=max(max_seq, s),
                     place=place)
    last = place.seq_gather(x)[:, -1:]
    return _logits(params, last, cfg, place_of(prof, (b, 1))), cache


# ------------------------------------------------------------------- cache
def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device="cuda",
               dtype=C, prof: Profile = SMOKE) -> list:
    """Decode cache of zeros, one dict per layer: K/V rows in ``dtype``
    (``max_seq`` rows, a local layer ``min(window, max_seq)``), the
    recurrent states in float32; with an encoder also zero
    cross-attention rows for ``n_frames`` frames.  On a ``prof`` with a
    mesh, the rank's shard (:func:`local_cache`)."""
    if on_mesh(prof):
        meta = init_cache(cfg, batch, max_seq, "meta", dtype)
        return [{n: torch.zeros(t.shape, dtype=t.dtype, device=device)
                 for n, t in c.items()}
                for c in local_cache(meta, cfg, prof)]
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


def local_cache(cache: list, cfg: ModelConfig, prof: Profile) -> list:
    """The rank's shard of a whole decode cache under ``prof``'s mesh:
    each entry cut by :func:`cache_specs` (``shardings.local_shard``)."""
    n_model = prof.mesh.size(prof.mesh.mesh_dim_names.index(prof.model_axis))
    specs = cache_specs(cfg, prof, n_model)
    return [local_tree(c, {n: spec[n] for n in c}, prof.mesh)
            for c, spec in zip(cache, specs, strict=True)]


def cache_specs(cfg: ModelConfig, prof: Profile, model_size: int) -> list:
    """The spec tree of :func:`init_cache`: one dict per layer.  K/V rows,
    the cross-attention's too, by ``prof.cache_kv`` (heads over the
    model axis where they divide it, else the rows); the recurrent
    states over the batch and their heads or channels over the model
    axis, mamba's conv rows whole on it."""
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


def _attn_decode(p, x, c, kind: str, pos, cfg: ModelConfig, place: Place):
    """One-token attention of x (B, 1, D) over the layer's cache ``c``:
    self-attention over ``k`` / ``v`` (updated in place), ``"cross"``
    over ``xk`` / ``xv`` (read only).  On a mesh x is the rank's batch
    rows, its attention tensor-parallel over its cache shard: where the
    K/V heads split over the model axis the shard is the rank's heads
    and the decode the dense one on them (its ring for ``"local"``),
    else its block of the rows (``blocks.decode_rows_tp``); the
    row-parallel partial outputs are summed over the model axis."""
    p = blocks.tp_weights(p, place, x.dtype)
    k, v = (c["xk"], c["xv"]) if kind == "cross" else (c["k"], c["v"])
    if not blocks.kv_split(cfg, place):
        out = blocks.decode_rows_tp(p, x, k, v, pos, cfg, place, kind)
    elif kind == "local":
        out = _local_decode(p, x, c, pos, blocks.local_heads(cfg, place))
    else:
        cross = kind == "cross"
        out = blocks.attn_decode(p, x, k, v, pos,
                                 blocks.local_heads(cfg, place), cross=cross,
                                 use_rope=not cross)[0]
    return place.leave(out)


def decode_layer(p, x, c, kind: str, pos, cfg: ModelConfig,
                 prof: Profile = SMOKE, place: Place = ALONE):
    """One layer of a decode step in the parameters' dtype: x (B, 1, D)
    -> the layer's output, its cache ``c`` updated in place.  On a mesh
    x is the rank's batch rows (B_b, 1, D) and ``c`` its cache shard."""
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    if kind in ("attn", "local"):
        h = _attn_decode(p["attn"], h, c, kind, pos, cfg, place)
    else:
        step = ssm.mamba_decode if kind == "mamba" else rglru.rglru_decode
        h, new = step(p["mixer"], h, c, cfg, place)
        c.update(new)
    x = x + h
    if "xattn" in p:
        h = rmsnorm(x, p["ln_x"], cfg.norm_eps)
        x = x + _attn_decode(p["xattn"], h, c, "cross", pos, cfg, place)
    if "mlp" in p or "moe" in p:
        h = rmsnorm(x, p["ln2"], cfg.norm_eps)
        x = x + (moe.moe_apply(p["moe"], h, cfg, prof, place) if "moe" in p
                 else blocks.mlp_apply(p["mlp"], h, cfg, place))
    return x


def decode_step(params, cache, tokens, pos, cfg: ModelConfig,
                prof: Profile = SMOKE):
    """One decode step in the parameters' dtype.  tokens (B, 1) int, pos
    (B,) int (position of the new token).  Returns (logits (B, 1,
    padded_vocab), cache), the cache updated in place.  On a mesh
    ``cache`` is the rank's shard (:func:`init_cache` with ``prof``) and
    the logits are whole on every rank."""
    place = place_of(prof, tokens.shape)
    x = place.leave(_lookup(params, tokens, cfg, params["embed"].dtype,
                            place))                        # (B, 1, D)
    pos = place.batch_block(pos)
    for p, kind, c in zip(params["layers"], layer_kinds(cfg), cache,
                          strict=True):
        x = decode_layer(p, x, c, kind, pos, cfg, prof, place)
    return _logits(params, x, cfg, place), cache
