"""The LM's forward pass (training) and decode step (serving), after
``repro.models.lm``.

The reference stacks each pattern slot's parameters and caches along a
leading (n_groups,) axis and scans over groups.  Here ``params["layers"]``
is a list with one parameter dict per layer, the cache holds one
(n_layers, B, Smax, KV, hd) tensor each for K and V, and the trunk is a
loop over layers.  The decode cache is updated in place.

Ported: layers of the ``"attn"`` kind with a SwiGLU or GELU MLP and
optional QKV bias — stablelm, qwen1.5, starcoder2 and internvl2's
backbone (with its stub vision prefix).  The other layer kinds, MoE and
cross-attention raise ``NotImplementedError``, as does ``prefill`` by
its absence (ROADMAP queue 1 item 12).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models import blocks
from repro_torch.models.blocks import C, _cast, _normal, rmsnorm
from repro_torch.models.config import ModelConfig
from repro_torch.tree import tree_map


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what the port's model does not
    cover yet."""
    for kind in cfg.pattern:
        if kind != "attn":
            raise NotImplementedError(
                f"{cfg.name}: {kind!r} layers are not ported yet "
                f"(ROADMAP queue 1 item 12)")
    if cfg.n_experts:
        raise NotImplementedError(
            f"{cfg.name}: MoE layers are not ported yet (ROADMAP queue 1 "
            f"item 12)")
    if cfg.encoder_layers:
        raise NotImplementedError(
            f"{cfg.name}: cross-attention (encoder-decoder) is not ported "
            f"yet (ROADMAP queue 1 item 12)")
    if cfg.mlp not in ("swiglu", "gelu"):
        raise NotImplementedError(f"{cfg.name}: MLP {cfg.mlp!r}")


# ------------------------------------------------------------------ params
def init_params(generator: torch.Generator, cfg: ModelConfig,
                dtype=C) -> dict:
    """Random parameters with the reference's shapes and distributions,
    drawn from ``generator`` on its device and stored in ``dtype``: bf16
    for serving, float32 for the master weights of training.  The values
    are the port's own: a torch generator does not reproduce the
    reference's threefry draws."""
    check_supported(cfg)
    d = cfg.d_model
    ones = lambda: torch.ones((d,), dtype=dtype, device=generator.device)
    params = {"embed": _normal(generator, (cfg.padded_vocab, d), 0.02,
                               dtype),
              "final_norm": ones()}
    if not cfg.tie_embeddings:
        params["head"] = _normal(generator, (d, cfg.padded_vocab), 0.02,
                                 dtype)
    params["layers"] = [
        {"ln1": ones(), "attn": blocks.init_attn(generator, cfg, dtype),
         "ln2": ones(), "mlp": blocks.init_mlp(generator, cfg, dtype=dtype)}
        for _ in range(cfg.n_layers)]
    return params


def params_to(params, device, dtype=None):
    """A copy of a parameter tree (dicts and lists of tensors) on
    ``device``, cast to ``dtype`` where one is given."""
    return tree_map(lambda t: t.to(device=device, dtype=dtype), params)


# ----------------------------------------------------------------- forward
def _sublayer(p, x, cfg: ModelConfig, positions, chunk):
    """One ``"attn"`` layer of the trunk, its weights cast to ``C`` here
    (so a rematerialised layer recasts them instead of keeping them)."""
    p = _cast(p)
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    x = x + blocks.attn_apply(p["attn"], h, cfg, positions=positions,
                              chunk=chunk)
    h = rmsnorm(x, p["ln2"], cfg.norm_eps)
    return x + blocks.mlp_apply(p["mlp"], h, cfg)


def trunk(params, x, cfg: ModelConfig, *, positions, chunk=0, remat=False):
    """The layers over x (B, S, D).  ``remat`` recomputes each layer in
    the backward pass instead of keeping its activations
    (``torch.utils.checkpoint``, the reference's ``jax.checkpoint``)."""
    for p in params["layers"]:
        if remat:
            x = checkpoint(_sublayer, p, x, cfg, positions, chunk,
                           use_reentrant=False)
        else:
            x = _sublayer(p, x, cfg, positions, chunk)
    return x


def forward(params, tokens, cfg: ModelConfig, *, prefix_embeds=None,
            chunk=0, remat=False):
    """tokens (B, S_t) int -> logits (B, S_total, padded_vocab) in bf16.

    ``prefix_embeds`` (B, Np, D): stub frontend output (vision patches),
    prepended to the token embeddings (internvl2).  ``chunk`` as in
    :func:`repro_torch.models.blocks.attend_full`."""
    check_supported(cfg)
    x = F.embedding(tokens, params["embed"].to(C))           # (B, S_t, D)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(C), x], dim=1)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    x = trunk(params, x, cfg, positions=positions, chunk=chunk, remat=remat)
    x = rmsnorm(x, params["final_norm"].to(C), cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["head"]
    return x @ head.to(C)


# ------------------------------------------------------------------- cache
def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device="cuda",
               dtype=C) -> dict:
    """Decode cache: ``{"k", "v"}``, each (n_layers, B, max_seq, KV, hd)
    zeros — the reference's per-slot (G, ...) stacks for a one-slot
    pattern."""
    check_supported(cfg)
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ------------------------------------------------------------------ decode
def decode_step(params, cache, tokens, pos, cfg: ModelConfig):
    """One decode step.  tokens (B, 1) int, pos (B,) int (position of the
    new token).  Returns (logits (B, 1, padded_vocab) in the parameters'
    dtype, cache), the cache updated in place."""
    check_supported(cfg)
    x = params["embed"][tokens]                              # (B, 1, D)
    for i, p in enumerate(params["layers"]):
        h = rmsnorm(x, p["ln1"], cfg.norm_eps)
        h, _, _ = blocks.attn_decode(p["attn"], h, cache["k"][i],
                                     cache["v"][i], pos, cfg)
        x = x + h
        h = rmsnorm(x, p["ln2"], cfg.norm_eps)
        x = x + blocks.mlp_apply(p["mlp"], h, cfg)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["head"]
    return x @ head, cache
