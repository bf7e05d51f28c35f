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

Here: RMSNorm, RoPE, the full-sequence attention of training and
prefill (``attn_apply`` over ``attend_full``, with grouped KV repeated to
full heads, optionally windowed, non-causal or in query chunks, and over
``attend_window_banded`` for the ``"local"`` kind's long causal
sequences; it returns the K/V rows that prefill caches, and takes a
cross-attention source), grouped decode attention (whole-cache and
chunked online-softmax forms; ``attn_decode`` also for the local window
and for cross-attention) and the SwiGLU / GELU MLP.  The reference's
sharding constraints are identities on one card and are left out; the
weights' spec trees (``attn_specs``, ``mlp_specs``) are kept for the
dry run and for laying the weights out over a mesh.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.runtime.shardings import Profile

C = torch.bfloat16  # compute dtype; the serving path stores its weights in it
NEG = -1e30


class MetaDraws:
    """Stands in for the generator of a build on the ``meta`` device
    (``lm.init_params(..., device="meta")``): every weight gets its shape
    and dtype and no values."""

    device = torch.device("meta")


def _normal(gen: torch.Generator, shape, std: float,
            dtype=C) -> torch.Tensor:
    """N(0, std²) drawn in float32 on the generator's device, then stored
    in ``dtype`` at once (no float32 copy of a bf16 weight outlives the
    call); on the ``meta`` device an empty tensor of the shape."""
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=gen.device)
    return (torch.randn(shape, generator=gen, device=gen.device,
                        dtype=torch.float32) * std).to(dtype)


def _cast(p: dict, dtype=C) -> dict:
    """A layer's parameters as used: every floating tensor of the
    (nested) dict cast to ``dtype``, the others as they are.  The
    full-sequence layers cast to their activations' dtype: float32
    masters to ``C`` under the training path's bf16 activations (the
    reference's ``_cast``), and nothing where the weights are stored in
    the activations' dtype, as the serving path stores them."""
    return {k: _cast(a, dtype) if isinstance(a, dict) else
            a.to(dtype) if a.is_floating_point() else a
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


def attend_full(q, k, v, q_pos, kv_pos, *, causal=True, window=0, chunk=0):
    """Exact attention; q (B,Q,H,hd) against k/v (B,S,H,hd) (KV already
    repeated to full heads).  q_pos (B, Q) / kv_pos (B, S) are absolute
    positions for the mask: causal, or all-true; ``window > 0`` also
    keeps each query to the keys in (pos - window, pos].  ``chunk > 0``
    computes the queries ``chunk`` at a time (bounded score memory); Q
    must then be a multiple of ``chunk``."""
    def mask_for(qp):
        if causal:
            m = kv_pos[:, None, :] <= qp[:, :, None]
        else:
            m = torch.ones((qp.shape[0], qp.shape[1], kv_pos.shape[1]),
                           dtype=torch.bool, device=qp.device)
        if window:
            m = m & (kv_pos[:, None, :] > qp[:, :, None] - window)
        return m

    nq = q.shape[1]
    if not chunk or nq <= chunk:
        return _sdpa_flat(q, k, v, mask_for(q_pos))
    if nq % chunk:
        raise ValueError(f"{nq} queries are not a multiple of chunk {chunk}")
    return torch.cat([
        _sdpa_flat(q[:, i:i + chunk], k, v, mask_for(q_pos[:, i:i + chunk]))
        for i in range(0, nq, chunk)], dim=1)


def banded_mask(n_chunks: int, window: int, device) -> torch.Tensor:
    """(n_chunks, w, 2w) bool: query i of a chunk (at 2w-frame position
    w + i) sees frame keys in (w + i - w, w + i]; the first chunk has no
    previous chunk, so its first w frame keys are masked too."""
    w = window
    qpos = torch.arange(w, device=device)[:, None] + w
    kpos = torch.arange(2 * w, device=device)[None, :]
    m = (kpos <= qpos) & (kpos > qpos - w)
    first = torch.arange(n_chunks, device=device)[:, None, None] == 0
    return torch.where(first, m & (kpos >= w), m)


def attend_window_banded(q, k, v, *, window):
    """Sliding-window causal attention in O(S * window): the sequence is
    cut into chunks of ``window``; each query chunk attends to its own
    and the previous key chunk (zeros before the first) under
    :func:`banded_mask`.  q/k/v (B, S, H, hd), S a multiple of
    ``window``."""
    b, s, h, hd = q.shape
    w = window
    if s % w:
        raise ValueError(f"sequence {s} is not a multiple of window {w}")
    nc = s // w
    qc = q.reshape(b, nc, w, h, hd)
    kc = k.reshape(b, nc, w, h, hd)
    vc = v.reshape(b, nc, w, h, hd)
    k2 = torch.cat([torch.cat([torch.zeros_like(kc[:, :1]), kc[:, :-1]], 1),
                    kc], dim=2)                      # (b, nc, 2w, h, hd)
    v2 = torch.cat([torch.cat([torch.zeros_like(vc[:, :1]), vc[:, :-1]], 1),
                    vc], dim=2)
    scores = torch.einsum("bnqhd,bnshd->bnhqs", qc.float(),
                          k2.float()) * hd ** -0.5
    mask = banded_mask(nc, w, q.device)
    scores = torch.where(mask[None, :, None], scores, NEG)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bnhqs,bnshd->bnqhd", probs, v2)
    return out.reshape(b, s, h, hd)


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


def init_attn(gen: torch.Generator, cfg: ModelConfig, dtype=C,
              cross=False) -> dict:
    """Attention weights; a cross-attention layer has no QKV bias."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    std = d ** -0.5
    p = {"wq": _normal(gen, (d, h * hd), std, dtype),
         "wk": _normal(gen, (d, kv * hd), std, dtype),
         "wv": _normal(gen, (d, kv * hd), std, dtype),
         "wo": _normal(gen, (h * hd, d), std, dtype)}
    if cfg.qkv_bias and not cross:
        for name, width in (("bq", h * hd), ("bk", kv * hd),
                            ("bv", kv * hd)):
            p[name] = torch.zeros((width,), dtype=dtype, device=gen.device)
    return p


def attn_specs(cfg: ModelConfig, prof: Profile, cross=False) -> dict:
    """The spec tree of :func:`init_attn`'s weights."""
    p = {"wq": prof.w_in(), "wk": prof.w_in(), "wv": prof.w_in(),
         "wo": prof.w_out()}
    if cfg.qkv_bias and not cross:
        p.update(bq=prof.bias_ff(), bk=prof.bias_ff(), bv=prof.bias_ff())
    return p


def uses_banded(kind: str, causal: bool, s: int, cfg: ModelConfig) -> bool:
    """The reference's choice of :func:`attend_window_banded`: a causal
    ``"local"`` layer over more than one window, in whole windows."""
    return bool(kind == "local" and causal and cfg.window
                and s > cfg.window and s % cfg.window == 0)


def attn_apply(p, x, cfg: ModelConfig, *, kind="attn", causal=True,
               positions=None, kv_src=None, kv_positions=None, chunk=0,
               use_rope=True, return_kv=False):
    """Attention over the full sequence (training and prefill).  x
    (B, S, D) at ``positions`` (B, S), 0..S-1 by default; ``kv_src``
    (B, S_kv, D) is a cross-attention source (x itself by default), at
    ``kv_positions`` (0..S_kv-1 for a source, else ``positions``).
    Weights are cast to x's dtype at use.  ``return_kv`` also returns
    the K/V rows (B, S_kv, KV, hd) after RoPE and before the grouped
    heads are repeated: the rows prefill caches."""
    p = _cast(p, x.dtype)
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    src = x if kv_src is None else kv_src.to(x.dtype)
    s_kv = src.shape[1]
    q = x @ p["wq"]
    k = src @ p["wk"]
    v = src @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, s_kv, kv, hd)
    v = v.reshape(b, s_kv, kv, hd)
    if positions is None:
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
    if kv_positions is None:
        kv_positions = positions if kv_src is None else torch.arange(
            s_kv, device=x.device)[None].expand(b, s_kv)
    if use_rope:
        sin, cos = rope_tables(positions, hd, cfg.rope_theta)
        q = apply_rope(q, sin, cos)
        sin, cos = rope_tables(kv_positions, hd, cfg.rope_theta)
        k = apply_rope(k, sin, cos)
    k_rep, v_rep = _repeat_kv(k, h // kv), _repeat_kv(v, h // kv)
    if uses_banded(kind, causal, s, cfg):
        out = attend_window_banded(q, k_rep, v_rep, window=cfg.window)
    else:
        out = attend_full(q, k_rep, v_rep, positions, kv_positions,
                          causal=causal,
                          window=cfg.window if kind == "local" else 0,
                          chunk=chunk)
    out = out.reshape(b, s, h * hd) @ p["wo"]
    return (out, k, v) if return_kv else out


def write_rows(cache, rows, slot):
    """cache (B, S, KV, hd) row ``slot[b]`` of each batch element set to
    ``rows[b]`` in place; rows of distinct batch elements, so no
    duplicate index.  A slot past the cache rewrites the last row with
    its own value (the reference's scatter drops it)."""
    b, smax = cache.shape[:2]
    idx_b = torch.arange(b, device=cache.device)
    sc = slot.long().clamp(max=smax - 1)
    keep = (slot < smax)[:, None, None]
    cache[idx_b, sc] = torch.where(keep, rows.to(cache.dtype),
                                   cache[idx_b, sc])


def decode_qkv(p, x, pos, cfg: ModelConfig, use_rope=True):
    """The new token's query (B, 1, KV, G, hd) and K/V rows (B, 1, KV,
    hd), RoPE at ``pos`` on the query and the key."""
    b = x.shape[0]
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q, knew, vnew = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if "bq" in p:
        q, knew, vnew = q + p["bq"], knew + p["bk"], vnew + p["bv"]
    q = q.reshape(b, 1, kv, h // kv, hd)
    knew = knew.reshape(b, 1, kv, hd)
    if use_rope:
        sin, cos = rope_tables(pos[:, None], hd, cfg.rope_theta)
        q, knew = apply_rope(q, sin, cos), apply_rope(knew, sin, cos)
    return q, knew, vnew.reshape(b, 1, kv, hd)


def attn_decode(p, x, cache_k, cache_v, pos, cfg: ModelConfig, *,
                kind="attn", cross=False, use_rope=True):
    """One-token decode.  x (B, 1, D); cache_k/v (B, Smax, KV, hd);
    pos (B,) position of the new token.

    Self-attention writes the new K/V rows into ``cache_k`` /
    ``cache_v`` at ``pos`` in place (a row whose position is past the
    cache is dropped, as the reference's scatter drops it) and attends
    causally, within the window for ``"local"``; ``cross`` attends to
    the whole cache and writes nothing (its K/V projections are not
    computed).  Returns ``(out, cache_k, cache_v)``."""
    b = x.shape[0]
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    if cross:
        q = (x @ p["wq"] + p["bq"] if "bq" in p else x @ p["wq"]).reshape(
            b, 1, kv, h // kv, hd)
        if use_rope:
            sin, cos = rope_tables(pos[:, None], hd, cfg.rope_theta)
            q = apply_rope(q, sin, cos)
    else:
        q, knew, vnew = decode_qkv(p, x, pos, cfg, use_rope)
        write_rows(cache_k, knew[:, 0], pos)
        write_rows(cache_v, vnew[:, 0], pos)
    smax = cache_k.shape[1]
    kv_pos = torch.arange(smax, device=x.device)[None, :]
    if cross:
        mask = torch.ones((b, smax), dtype=torch.bool, device=x.device)
    else:
        mask = kv_pos <= pos[:, None]
    if kind == "local" and cfg.window:
        mask = mask & (kv_pos > pos[:, None] - cfg.window)
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


def mlp_specs(cfg: ModelConfig, prof: Profile) -> dict:
    """The spec tree of :func:`init_mlp`'s weights."""
    if cfg.mlp == "swiglu":
        return {"w1": prof.w_in(), "w3": prof.w_in(), "w2": prof.w_out()}
    return {"w1": prof.w_in(), "w2": prof.w_out()}


def mlp_apply(p, x, cfg: ModelConfig):
    """SwiGLU where the layer has ``w3``, else GELU in its tanh form
    (``jax.nn.gelu``'s default)."""
    if "w3" in p:
        h = F.silu(x @ p["w1"]) * (x @ p["w3"])
    else:
        h = F.gelu(x @ p["w1"], approximate="tanh")
    return h @ p["w2"]
