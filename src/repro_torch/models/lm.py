"""The LM's decode step, after ``repro.models.lm`` (decode subset).

The reference stacks each pattern slot's parameters and caches along a
leading (n_groups,) axis and scans over groups.  Here ``params["layers"]``
is a list with one parameter dict per layer, the cache holds one
(n_layers, B, Smax, KV, hd) tensor each for K and V, and the trunk is a
loop over layers.  The decode cache is updated in place.

Ported: layers of the ``"attn"`` kind with a SwiGLU or GELU MLP and
optional QKV bias — stablelm, qwen1.5, starcoder2 and internvl2's
backbone.  The other layer kinds, MoE and cross-attention raise
``NotImplementedError``, as do ``prefill`` and ``forward`` by their
absence (ROADMAP queue 1 item 12).
"""

from __future__ import annotations

import torch

from repro_torch.models import blocks
from repro_torch.models.blocks import C, _normal, rmsnorm
from repro_torch.models.config import ModelConfig


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what the port's decode path does
    not cover yet."""
    for kind in cfg.pattern:
        if kind != "attn":
            raise NotImplementedError(
                f"{cfg.name}: decode of {kind!r} layers is not ported yet "
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
def init_params(generator: torch.Generator, cfg: ModelConfig) -> dict:
    """Random parameters with the reference's shapes and distributions,
    drawn from ``generator`` on its device and stored in bf16.  The
    values are the port's own: a torch generator does not reproduce the
    reference's threefry draws."""
    check_supported(cfg)
    d = cfg.d_model
    ones = lambda: torch.ones((d,), dtype=C, device=generator.device)
    params = {"embed": _normal(generator, (cfg.padded_vocab, d), 0.02),
              "final_norm": ones()}
    if not cfg.tie_embeddings:
        params["head"] = _normal(generator, (d, cfg.padded_vocab), 0.02)
    params["layers"] = [
        {"ln1": ones(), "attn": blocks.init_attn(generator, cfg),
         "ln2": ones(), "mlp": blocks.init_mlp(generator, cfg)}
        for _ in range(cfg.n_layers)]
    return params


def params_to(params, device, dtype=None):
    """A copy of a parameter tree (dicts and lists of tensors) on
    ``device``, cast to ``dtype`` where one is given."""
    if isinstance(params, dict):
        return {k: params_to(v, device, dtype) for k, v in params.items()}
    if isinstance(params, list):
        return [params_to(v, device, dtype) for v in params]
    return params.to(device=device, dtype=dtype)


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
