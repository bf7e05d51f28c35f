"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427),
after ``repro.models.rglru``.

Real-gated linear recurrent unit with a diagonal recurrence:
    r_t = sigmoid(x_t * w_r + b_r)          (recurrence gate)
    i_t = sigmoid(x_t * w_i + b_i)          (input gate)
    a_t = exp(c * softplus(lam) * (-r_t))   (per-channel decay in (0,1))
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The full-sequence form runs the recurrence as a log-depth doubling scan
in float32 (ceil(log2 S) steps; the reference's ``associative_scan``),
never as a loop over positions; decode is an O(1) state update.  The
conv is 4 taps wide whatever ``cfg.conv_width`` says, as in the
reference.

On a mesh (the ``place`` argument, ``runtime/shardings.Place``;
``ALONE``, the identity, without one) the width W splits over the model
axis after ``w_x``, as the reference's ``act_btf`` constraint splits
it: a rank takes its normalised block, gathers its sequence and
computes its channel block through ``w_x`` and ``w_gate`` (column
blocks, their FSDP shards gathered at use), its columns of the
replicated conv, its gates and ``lam`` (already cut) and the doubling
scan, channel by channel; its rows of ``w_out`` give partial outputs
summed into the rank's block.  The decode state (B_b, W / n) and conv
rows (B_b, 3, W / n) are the rank's channels.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.blocks import C, _normal
from repro_torch.models.config import ModelConfig
from repro_torch.models.ssm import _causal_conv, conv_tail
from repro_torch.runtime.shardings import ALONE, Place, Profile, block

_C_GATE = 8.0
CONV_WIDTH = 4


def init_rglru(gen: torch.Generator, cfg: ModelConfig, dtype=C) -> dict:
    """The reference's shapes and constants: gates 0, ``lam`` 0.5; the
    projections N(0, 1/d), the conv N(0, 0.01)."""
    d = cfg.d_model
    w = cfg.rnn_width or d
    std = d ** -0.5
    vec = lambda v: torch.full((w,), v, dtype=dtype, device=gen.device)
    return {
        "w_x": _normal(gen, (d, w), std, dtype),
        "w_gate": _normal(gen, (d, w), std, dtype),
        "conv": _normal(gen, (CONV_WIDTH, w), 0.1, dtype),
        "w_r": vec(0.0), "b_r": vec(0.0), "w_i": vec(0.0), "b_i": vec(0.0),
        "lam": vec(0.5),
        "w_out": _normal(gen, (w, d), std, dtype),
    }


def rglru_specs(cfg: ModelConfig, prof: Profile) -> dict:
    """The spec tree of :func:`init_rglru`'s weights."""
    return {
        "w_x": prof.w_in(), "w_gate": prof.w_in(), "conv": prof.vector(),
        "w_r": prof.bias_ff(), "b_r": prof.bias_ff(),
        "w_i": prof.bias_ff(), "b_i": prof.bias_ff(),
        "lam": prof.bias_ff(), "w_out": prof.w_out(),
    }


GATES = ("w_r", "b_r", "w_i", "b_i", "lam")


def _rank_weights(p, place: Place, dtype) -> dict:
    """The mixer's weights as the rank uses them, in ``dtype`` (module
    docstring); the leaves themselves, cast, off a mesh."""
    out = {"w_x": place.zero(p["w_x"], 0),
           "w_gate": place.zero(p["w_gate"], 0),
           "conv": block(place.shared(p["conv"], model=True), -1, place.m,
                         place.n_model),
           "w_out": place.zero(p["w_out"], 1)}
    out.update({k: place.shared(p[k], model=False) for k in GATES})
    return {k: t.to(dtype) for k, t in out.items()}


def _gates(p, xb):
    """xb (..., W) float32 -> (a, ix): the decay and the gated input."""
    pf = {k: p[k].float() for k in GATES}
    r = torch.sigmoid(xb * pf["w_r"] + pf["b_r"])
    i = torch.sigmoid(xb * pf["w_i"] + pf["b_i"])
    a = torch.exp(-_C_GATE * F.softplus(pf["lam"]) * r)
    ix = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * xb)
    return a, ix


def linear_scan(a, x):
    """h_t = a_t * h_{t-1} + x_t along dim 1 from h_{-1} = 0, by
    recursive doubling: after the step at offset d each position holds
    the composition of the (up to) 2d steps ending there."""
    d = 1
    while d < a.shape[1]:
        x = torch.cat([x[:, :d], x[:, d:] + a[:, d:] * x[:, :-d]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return x


def rglru_apply(p, x, cfg: ModelConfig, *, return_state=False,
                place: Place = ALONE):
    """Full sequence.  x (B, S, D) -> (B, S, D); ``return_state`` also
    returns the decode cache ``{state (B, W), conv (B, 3, W)}``.  With
    the ``place`` of a rank on a mesh (module docstring) x is the rank's
    normalised block (B_b, S_b, D), the output its block and the cache
    its shard."""
    x = place.enter(x)
    cd = x.dtype
    p = _rank_weights(p, place, cd)
    xb_raw = x @ p["w_x"]
    xb = _causal_conv(xb_raw, p["conv"]).float()
    gate = F.gelu((x @ p["w_gate"]).float(), approximate="tanh")
    a, ix = _gates(p, xb)
    h = linear_scan(a, ix)
    out = place.leave((h * gate).to(cd) @ p["w_out"])
    if return_state:
        return out, {"state": h[:, -1],
                     "conv": conv_tail(xb_raw, CONV_WIDTH, cfg.name)}
    return out


def rglru_init_cache(cfg: ModelConfig, batch: int, device="cuda",
                     dtype=torch.float32) -> dict:
    w = cfg.rnn_width or cfg.d_model
    return {"state": torch.zeros((batch, w), dtype=dtype, device=device),
            "conv": torch.zeros((batch, CONV_WIDTH - 1, w), dtype=dtype,
                                device=device)}


def rglru_decode(p, x, cache, cfg: ModelConfig, place: Place = ALONE):
    """One-token step in the parameters' dtype.  x (B, 1, D).  Returns
    (out, new cache).  With the ``place`` of a rank on a mesh x is its
    batch rows, the cache its channels (module docstring) and the output
    its partial sums summed over the model axis."""
    x = place.enter(x)
    cd = x.dtype
    p = _rank_weights(p, place, cd)
    xb = x @ p["w_x"]                                        # (B,1,W)
    window = torch.cat([cache["conv"].to(cd), xb], dim=1)    # (B,4,W)
    xc = torch.einsum("bwc,wc->bc", window.float(), p["conv"].float())
    gate = F.gelu((x[:, 0] @ p["w_gate"]).float(), approximate="tanh")
    a, ix = _gates(p, xc)
    h = cache["state"].float() * a + ix
    out = place.leave(((h * gate).to(cd) @ p["w_out"])[:, None])
    return out, {"state": h.to(cache["state"].dtype),
                 "conv": window[:, 1:].to(cache["conv"].dtype)}
