"""Mamba2 SSD (state-space duality) block, after ``repro.models.ssm``
[arXiv:2405.21060].

Chunked SSD: the intra-chunk terms are dense products (quadratic within
a chunk only); the state passes from chunk to chunk by a loop over the
chunks (the reference's ``associative_scan`` over chunks, whose combine
multiplies the compute-dtype states by the float32 chunk decays cast to
the compute dtype, as here; 16 chunks at 4,096 tokens).  Decode is an
O(1) state update.

The full-sequence form computes in its input's dtype where the
reference computes in bf16 (``C``), and the decay, ``dt`` and the
chunk sums in float32, as the reference does; the decode step keeps
its state in float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.blocks import C, _cast, _normal, rmsnorm
from repro_torch.models.config import ModelConfig
from repro_torch.runtime.shardings import Profile


def init_mamba(gen: torch.Generator, cfg: ModelConfig, dtype=C) -> dict:
    """The reference's shapes and constants: ``a_log = log(linspace(1,
    16, H))``, ``dt_bias`` 0, ``d_skip`` 1, ``norm`` 1; the projections
    N(0, 1/d), the conv N(0, 0.01)."""
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    std = d ** -0.5
    vec = lambda a: a.to(device=gen.device, dtype=dtype)
    return {
        # fused in-projection: [z, x, B, C, dt]
        "w_in": _normal(gen, (d, 2 * di + 2 * n + h), std, dtype),
        "conv": _normal(gen, (cfg.conv_width, di + 2 * n), 0.1, dtype),
        "a_log": vec(torch.log(torch.linspace(1.0, 16.0, h))),
        "dt_bias": vec(torch.zeros(h)),
        "d_skip": vec(torch.ones(h)),
        "norm": vec(torch.ones(di)),
        "w_out": _normal(gen, (di, d), std, dtype),
    }


def mamba_specs(cfg: ModelConfig, prof: Profile) -> dict:
    """The spec tree of :func:`init_mamba`'s weights."""
    return {
        "w_in": prof.w_in(), "conv": prof.vector(),
        "a_log": prof.vector(), "dt_bias": prof.vector(),
        "d_skip": prof.vector(), "norm": prof.bias_ff(),
        "w_out": prof.w_out(),
    }


def _split_proj(p, x, cfg: ModelConfig):
    di, n = cfg.d_inner, cfg.ssm_state
    zxbcdt = x @ p["w_in"]
    return (zxbcdt[..., :di], zxbcdt[..., di:2 * di],
            zxbcdt[..., 2 * di:2 * di + n],
            zxbcdt[..., 2 * di + n:2 * di + 2 * n],
            zxbcdt[..., 2 * di + 2 * n:])


def _causal_conv(seq, weight):
    """Depthwise causal conv: seq (B, S, Ch), weight (W, Ch); the taps
    summed in float32, the result in seq's dtype."""
    w, s = weight.shape[0], seq.shape[1]
    pad = F.pad(seq, (0, 0, w - 1, 0))
    out = torch.zeros(seq.shape, dtype=torch.float32, device=seq.device)
    for i in range(w):
        out = out + pad[:, i:i + s].float() * weight[i].float()
    return out.to(seq.dtype)


def conv_tail(seq, width: int, what: str):
    """The last ``width - 1`` rows of ``seq`` (B, S, Ch) as float32: a
    decode conv cache.  The reference slices ``seq[:, S - (width - 1):]``
    and so keeps fewer rows when S < width - 1, which breaks the next
    decode step on the shape; here that raises."""
    s = seq.shape[1]
    if s < width - 1:
        raise ValueError(f"{what}: a prompt of {s} tokens is shorter than "
                         f"the conv cache's {width - 1} rows")
    return seq[:, s - (width - 1):].float()


def mamba_apply(p, x, cfg: ModelConfig, *, return_state=False):
    """Full-sequence SSD.  x (B, S, D) -> (B, S, D); ``return_state``
    also returns the decode cache ``{state, conv}`` after S."""
    cd = x.dtype
    p = _cast(p, cd)
    bsz, s_orig, _ = x.shape
    di, n, h, hp = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    q = min(cfg.ssm_chunk, s_orig)
    pad = (-s_orig) % q
    s = s_orig + pad
    nc = s // q

    z, xin, b, c, dt = _split_proj(p, x, cfg)
    conv_in = torch.cat([xin, b, c], dim=-1)
    conv_out = F.silu(_causal_conv(conv_in, p["conv"]))
    xin, b, c = (conv_out[..., :di], conv_out[..., di:di + n],
                 conv_out[..., di + n:])

    a = -torch.exp(p["a_log"].float())                       # (H,)
    dt = F.softplus(dt.float() + p["dt_bias"].float())      # (B,S,H)
    if pad:
        # dt = 0 on padded rows: decay 1, contribution 0, so padding is
        # invisible to both outputs and the final state
        rows = lambda t: F.pad(t, (0, 0, 0, pad))
        dt, xin, b, c, z = map(rows, (dt, xin, b, c, z))
    da = dt * a                                              # <= 0

    xh = xin.reshape(bsz, nc, q, h, hp)
    bc = b.reshape(bsz, nc, q, n).float()
    cc = c.reshape(bsz, nc, q, n).float()
    dac = da.reshape(bsz, nc, q, h)
    dtc = dt.reshape(bsz, nc, q, h)

    cums = torch.cumsum(dac, dim=2)                          # (B,NC,Q,H)
    # intra-chunk: Y[i] = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j;
    # masked BEFORE exp (exp of the i < j entries overflows)
    diff = cums[:, :, :, None] - cums[:, :, None]            # (B,NC,Q,Q,H)
    tri = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(torch.where(tri[None, None, :, :, None], diff, -1e9))
    scores = torch.einsum("bcin,bcjn->bcij", cc, bc)         # (B,NC,Q,Q)
    wts = (scores.to(cd)[..., None] * decay.to(cd)
           * dtc.to(cd)[:, :, None])                         # (B,NC,Q,Q,H)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", wts, xh)

    # inter-chunk: each chunk's end state, then the states in order
    to_end = torch.exp(cums[:, :, -1:, :] - cums)            # (B,NC,Q,H)
    u = (dtc * to_end).to(cd)[..., None] * xh                # (B,NC,Q,H,P)
    s_c = torch.einsum("bcjn,bcjhp->bchpn", bc.to(cd), u)    # (B,NC,H,P,N)
    chunk_decay = torch.exp(cums[:, :, -1, :]).to(cd)        # (B,NC,H)
    states = [s_c[:, 0]]
    for i in range(1, nc):
        states.append(states[-1] * chunk_decay[:, i, :, None, None]
                      + s_c[:, i])
    # incoming state of chunk i = the state after chunk i - 1
    state_in = torch.stack([torch.zeros_like(states[0])] + states[:-1], 1)
    y_inter = torch.einsum("bcin,bchpn->bcihp", cc.to(cd), state_in) \
        * torch.exp(cums)[..., None].to(cd)

    y = (y_intra + y_inter).reshape(bsz, s, h, hp)
    y = y + p["d_skip"][None, None, :, None] * xin.reshape(bsz, s, h, hp)
    y = y.reshape(bsz, s, di) * F.silu(z.float()).to(cd)
    y = rmsnorm(y[:, :s_orig], p["norm"], cfg.norm_eps)
    out = y @ p["w_out"]
    if return_state:
        return out, {"state": states[-1].float(),
                     "conv": conv_tail(conv_in, cfg.conv_width, cfg.name)}
    return out


def mamba_init_cache(cfg: ModelConfig, batch: int, device="cuda",
                     dtype=torch.float32) -> dict:
    di, n, h, hp = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    return {"state": torch.zeros((batch, h, hp, n), dtype=dtype,
                                 device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, di + 2 * n),
                                dtype=dtype, device=device)}


def mamba_decode(p, x, cache, cfg: ModelConfig):
    """One-token step in the parameters' dtype.  x (B, 1, D); cache
    ``{state (B,H,P,N), conv (B,W-1,Ch)}``.  Returns (out, new cache)."""
    cd = x.dtype
    bsz = x.shape[0]
    di, n, h, hp = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    z, xin, b, c, dt = _split_proj(p, x, cfg)
    conv_in = torch.cat([xin, b, c], dim=-1)                 # (B,1,Ch)
    window = torch.cat([cache["conv"].to(cd), conv_in], dim=1)  # (B,W,Ch)
    conv_out = F.silu(torch.einsum("bwc,wc->bc", window.float(),
                                   p["conv"].float()))[:, None].to(cd)
    xin, b, c = (conv_out[..., :di], conv_out[..., di:di + n],
                 conv_out[..., di + n:])
    a = -torch.exp(p["a_log"].float())
    dt = F.softplus(dt[:, 0].float() + p["dt_bias"].float())  # (B,H)
    da = torch.exp(dt * a)
    xh = xin.reshape(bsz, h, hp).float()
    state = cache["state"].float() * da[..., None, None] + torch.einsum(
        "bh,bhp,bn->bhpn", dt, xh, b[:, 0].float())
    y = torch.einsum("bn,bhpn->bhp", c[:, 0].float(), state)
    y = y + p["d_skip"].float()[None, :, None] * xh
    y = y.reshape(bsz, 1, di).to(cd) * F.silu(z.float()).to(cd)
    y = rmsnorm(y, p["norm"], cfg.norm_eps)
    return y @ p["w_out"], {"state": state.to(cache["state"].dtype),
                            "conv": window[:, 1:].to(cache["conv"].dtype)}
