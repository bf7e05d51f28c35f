"""Layer primitives of the decode and training paths, after
``repro.models.blocks``.

Conventions, as in the reference:
- the training path keeps float32 master weights and casts them to
  bf16 (``C``) at each use (``_cast``), as the reference does for every
  weight;
- the decode path computes in the parameters' dtype.  The serving path
  stores bf16, which is exactly what the reference's cast gives, and so
  computes in bf16 too.  Parameters stored in float32 give the same
  algorithm in float32 there (a check of the math free of bf16
  rounding);
- norms, RoPE, attention scores and the softmax accumulate in float32,
  and probabilities are cast to the compute dtype before the value
  product;
- masked scores are ``NEG`` (a large finite negative), not ``-inf``.

Here: RMSNorm, RoPE, the full-sequence attention of training
(``attn_apply`` over ``attend_full``, with grouped KV repeated to full
heads, optionally in query chunks), grouped decode attention
(whole-cache and chunked online-softmax forms) and the SwiGLU / GELU
MLP.  The sliding-window attention (``attend_window_banded``, the
``"local"`` kind) is not ported yet, and ``attn_apply`` does not return
the K/V rows that prefill would cache.  The reference's sharding
constraints are identities on one card and are left out.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig

C = torch.bfloat16  # compute dtype; the serving path stores its weights in it
NEG = -1e30


def _normal(gen: torch.Generator, shape, std: float,
            dtype=C) -> torch.Tensor:
    """N(0, std²) drawn in float32 on the generator's device, then stored
    in ``dtype`` at once (no float32 copy of a bf16 weight outlives the
    call)."""
    return (torch.randn(shape, generator=gen, device=gen.device,
                        dtype=torch.float32) * std).to(dtype)


def _cast(p: dict) -> dict:
    """A layer's parameters as used: every float32 tensor of the (nested)
    dict cast to ``C``, the others as they are."""
    return {k: _cast(a) if isinstance(a, dict) else
            a.to(C) if a.dtype == torch.float32 else a
            for k, a in p.items()}


# --------------------------------------------------------------- norms/rope
def rmsnorm(x, scale, eps):
    xf = x.float()
    ms = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps)).to(scale.dtype) * scale


@functools.lru_cache(maxsize=None)
def _rope_freqs(head_dim: int, theta: float, device: torch.device):
    """float32 RoPE frequencies, computed in float64 and rounded, as the
    reference's numpy frequencies are when they meet its float32
    positions.  Cached: one host-to-device copy per (shape, device)."""
    half = head_dim // 2
    freqs = 1.0 / (theta ** (np.arange(0, half) / half))
    return torch.from_numpy(freqs.astype(np.float32)).to(device)


def rope_tables(positions, head_dim, theta):
    """positions (...,) int -> (..., head_dim/2) float32 sin/cos tables."""
    freqs = _rope_freqs(head_dim, float(theta), positions.device)
    ang = positions[..., None].float() * freqs
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x, sin, cos):
    """x (B, S, ..., hd); sin/cos (B, S, hd/2) broadcast over head axes."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    while sin.dim() < x.dim():
        sin, cos = sin[..., None, :], cos[..., None, :]
    sin, cos = sin.float(), cos.float()
    x1f, x2f = x1.float(), x2.float()
    return torch.cat([x1f * cos - x2f * sin, x2f * cos + x1f * sin],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------- attention
def _repeat_kv(k, g):
    """(B, S, KV, hd) -> (B, S, KV*g, hd): grouped KV expanded to full
    heads for the training path (decode keeps the grouped form)."""
    if g == 1:
        return k
    b, s, kv, hd = k.shape
    return k[:, :, :, None].expand(b, s, kv, g, hd).reshape(b, s, kv * g, hd)


def _sdpa_flat(q, k, v, mask):
    """q (B,Q,H,hd), k/v (B,S,H,hd) in the compute dtype, mask (B,Q,S) or
    (Q,S) bool.  Scores in float32 (the reference's
    ``preferred_element_type``)."""
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bshd->bhqs", q.float(), k.float()) * scale
    if mask.dim() == 2:
        mask = mask[None]
    scores = torch.where(mask[:, None], scores, NEG)   # (B,1,Q,S) broadcast
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhqs,bshd->bqhd", probs, v)


def attend_full(q, k, v, q_pos, kv_pos, *, chunk=0):
    """Exact causal attention; q (B,Q,H,hd) against k/v (B,S,H,hd) (KV
    already repeated to full heads).  q_pos (B, Q) / kv_pos (B, S) are
    absolute positions for the causal mask.  ``chunk > 0`` computes the
    queries ``chunk`` at a time (bounded score memory); Q must then be a
    multiple of ``chunk``."""
    def mask_for(qp):
        return kv_pos[:, None, :] <= qp[:, :, None]

    nq = q.shape[1]
    if not chunk or nq <= chunk:
        return _sdpa_flat(q, k, v, mask_for(q_pos))
    if nq % chunk:
        raise ValueError(f"{nq} queries are not a multiple of chunk {chunk}")
    return torch.cat([
        _sdpa_flat(q[:, i:i + chunk], k, v, mask_for(q_pos[:, i:i + chunk]))
        for i in range(0, nq, chunk)], dim=1)


def _sdpa(q, k, v, mask):
    """Grouped decode attention: q (B,Q,KV,G,hd), k/v (B,S,KV,hd) in
    the compute dtype, mask (B,Q,S) or (Q,S) bool.  Scores in float32
    (the reference's ``preferred_element_type``)."""
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqkgd,bskd->bkgqs", q.float(), k.float()) * scale
    if mask.dim() == 2:
        mask = mask[None, None, None]
    else:
        mask = mask[:, None, None]  # (B,1,1,Q,S)
    scores = torch.where(mask, scores, NEG)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bkgqs,bskd->bqkgd", probs, v)


def _decode_attend_chunked(q, cache_k, cache_v, mask, chunk=2048):
    """Online-softmax decode attention over a long cache, one chunk at a
    time (flash-decoding structure), all in float32.

    q (B,1,KV,G,hd); cache (B,S,KV,hd) any dtype; mask (B,S) bool.  As
    the reference's ``dynamic_slice`` does, a chunk that would run past
    the end starts at S - chunk instead (so it may overlap the previous
    one); ``chunk`` must not exceed S."""
    b, _, kv, g, hd = q.shape
    smax = cache_k.shape[1]
    if chunk > smax:
        raise ValueError(f"chunk {chunk} exceeds the cache length {smax}")
    nch = -(-smax // chunk)
    scale = hd ** -0.5
    q0 = q[:, 0].float()                                    # (B,KV,G,hd)
    m = torch.full((b, kv, g), -torch.inf, device=q.device)
    l = torch.zeros((b, kv, g), device=q.device)
    acc = torch.zeros((b, kv, g, hd), device=q.device)
    for i in range(nch):
        start = min(i * chunk, smax - chunk)
        ks = cache_k[:, start:start + chunk].float()
        vs = cache_v[:, start:start + chunk].float()
        msk = mask[:, start:start + chunk]
        s = torch.einsum("bkgd,bskd->bkgs", q0, ks) * scale  # (B,KV,G,c)
        s = torch.where(msk[:, None, None, :], s, NEG)
        m2 = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp(m - m2)
        pr = torch.exp(s - m2[..., None])
        l = l * corr + pr.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bkgs,bskd->bkgd", pr, vs)
        m = m2
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out[:, None].to(q.dtype)                         # (B,1,KV,G,hd)


def init_attn(gen: torch.Generator, cfg: ModelConfig, dtype=C) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    std = d ** -0.5
    p = {"wq": _normal(gen, (d, h * hd), std, dtype),
         "wk": _normal(gen, (d, kv * hd), std, dtype),
         "wv": _normal(gen, (d, kv * hd), std, dtype),
         "wo": _normal(gen, (h * hd, d), std, dtype)}
    if cfg.qkv_bias:
        for name, width in (("bq", h * hd), ("bk", kv * hd),
                            ("bv", kv * hd)):
            p[name] = torch.zeros((width,), dtype=dtype, device=gen.device)
    return p


def attn_apply(p, x, cfg: ModelConfig, *, positions=None, chunk=0):
    """Causal self-attention over the full sequence (training).  x
    (B, S, D) at ``positions`` (B, S), 0..S-1 by default.  Weights are
    cast to ``C`` at use."""
    p = _cast(p)
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, s, kv, hd)
    v = v.reshape(b, s, kv, hd)
    if positions is None:
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
    sin, cos = rope_tables(positions, hd, cfg.rope_theta)
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)
    out = attend_full(q, _repeat_kv(k, h // kv), _repeat_kv(v, h // kv),
                      positions, positions, chunk=chunk)
    return out.reshape(b, s, h * hd) @ p["wo"]


def attn_decode(p, x, cache_k, cache_v, pos, cfg: ModelConfig):
    """One-token decode of a global-attention layer.  x (B, 1, D);
    cache_k/v (B, Smax, KV, hd); pos (B,) position of the new token.

    Writes the new K/V rows into ``cache_k`` / ``cache_v`` in place (a
    row whose position is past the cache is dropped, as the reference's
    scatter drops it) and returns ``(out, cache_k, cache_v)``."""
    b, _, d = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = x @ p["wq"]
    if "bq" in p:
        q = q + p["bq"]
    q = q.reshape(b, 1, kv, h // kv, hd)
    sin, cos = rope_tables(pos[:, None], hd, cfg.rope_theta)
    q = apply_rope(q, sin, cos)
    knew = x @ p["wk"]
    vnew = x @ p["wv"]
    if "bk" in p:
        knew, vnew = knew + p["bk"], vnew + p["bv"]
    knew = apply_rope(knew.reshape(b, 1, kv, hd), sin, cos)
    vnew = vnew.reshape(b, 1, kv, hd)
    smax = cache_k.shape[1]
    # rows of distinct batch elements: no duplicate index; a position
    # past the cache rewrites the last row with its own value
    idx_b = torch.arange(b, device=x.device)
    posc = pos.long().clamp(max=smax - 1)
    keep = (pos < smax)[:, None, None]
    for cache, new in ((cache_k, knew), (cache_v, vnew)):
        cache[idx_b, posc] = torch.where(keep, new[:, 0].to(cache.dtype),
                                         cache[idx_b, posc])
    kv_pos = torch.arange(smax, device=x.device)[None, :]
    mask = kv_pos <= pos[:, None]
    if smax > 8192:
        out = _decode_attend_chunked(q, cache_k, cache_v, mask)
    else:
        out = _sdpa(q, cache_k.to(q.dtype), cache_v.to(q.dtype),
                    mask[:, None])
    out = out.reshape(b, 1, h * hd) @ p["wo"]
    return out, cache_k, cache_v


# --------------------------------------------------------------------- MLP
def init_mlp(gen: torch.Generator, cfg: ModelConfig, d_ff=None,
             dtype=C) -> dict:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    std = d ** -0.5
    if cfg.mlp == "swiglu":
        return {"w1": _normal(gen, (d, f), std, dtype),
                "w3": _normal(gen, (d, f), std, dtype),
                "w2": _normal(gen, (f, d), std, dtype)}
    return {"w1": _normal(gen, (d, f), std, dtype),
            "w2": _normal(gen, (f, d), std, dtype)}


def mlp_apply(p, x, cfg: ModelConfig):
    """SwiGLU where the layer has ``w3``, else GELU in its tanh form
    (``jax.nn.gelu``'s default)."""
    if "w3" in p:
        h = F.silu(x @ p["w1"]) * (x @ p["w3"])
    else:
        h = F.gelu(x @ p["w1"], approximate="tanh")
    return h @ p["w2"]
