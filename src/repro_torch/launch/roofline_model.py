"""Roofline terms of dry-run records, per card, after
``repro.launch.roofline_model``.

The formulas are the reference's; the constants it hard-codes (the
chip's peak rate, memory and link rates, and the mesh) are one
:class:`Machine` passed in.  A record's FLOPs, bytes and collective
bytes are per card (``launch/dryrun.py``), so:

    compute term    = flops_per_card / peak_flops
    collective term = coll_bytes_per_card / link_bw
    memory term     = modeled_bytes_per_card / hbm_bw

Two memory-byte sources are reported:
  * ``hlo``     -- the dry run's dispatch count: the bytes of every op's
    tensor inputs and outputs.  Nothing is fused there, so it is a loose
    UPPER bound on HBM traffic (the key keeps the reference's name).
  * ``modeled`` -- the reference's analytical proxy (formulas below):
    optimizer state traffic + FSDP parameter gathers + boundary
    activations + attention score spill + logits.  The primary memory
    term.

The H100 rates of :func:`h100`: 3.35 TB/s of HBM (the data sheet), and
as the compute peak the bf16 matmul rate ``chip_smoke.py`` measured at
8,192^3 on an H100 80GB HBM3 at 700 W, the top of its range (7.77e14 to
8.05e14 FLOP/s).  One card cannot measure its links: ``link_bw`` is an
input with no default, and every result marks the collective term
unverified.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs import SHAPES, get_config
from repro_torch.launch.mesh import production_mesh_shape
from repro_torch.models.config import ModelConfig

H100_HBM_BW = 3.35e12           # bytes/s, NVIDIA's H100 SXM data sheet
H100_BF16_MATMUL = 8.05e14      # FLOP/s, chip_smoke.py's measured rate


@dataclasses.dataclass(frozen=True)
class Machine:
    """The hardware and mesh the terms are taken against."""

    peak_flops: float   # FLOP/s per card
    hbm_bw: float       # bytes/s per card
    link_bw: float      # bytes/s per card on the interconnect (unverified)
    chips: int          # cards in the mesh
    model: int          # model-axis size
    data: int           # data-axis size (within one pod)


def h100(n_cards: int, *, link_bw: float, multi_pod: bool = False
         ) -> Machine:
    """H100 cards on the production mesh (``launch/mesh.py``)."""
    shape, axes = production_mesh_shape(n_cards, multi_pod)
    sizes = dict(zip(axes, shape))
    return Machine(peak_flops=H100_BF16_MATMUL, hbm_bw=H100_HBM_BW,
                   link_bw=link_bw, chips=n_cards, model=sizes["model"],
                   data=sizes["data"])


def modeled_memory_bytes(cfg: ModelConfig, shape, *, optimizer: str,
                         n_mb: int, huge: bool, machine: Machine) -> float:
    """Analytical per-card HBM bytes for one step (a fused-kernel proxy)."""
    chips, model, data = machine.chips, machine.model, machine.data
    n = cfg.param_count()
    b, s = shape.global_batch, shape.seq_len
    tokens = b * s
    n_per_chip = n / chips

    total = 0.0
    if shape.mode == "train":
        # optimizer: read p,g(,m,v) + write p(,m,v)
        opt_words = 7 if optimizer == "adamw" else 3
        total += opt_words * 4 * n_per_chip
        # FSDP gathers: per microbatch, fwd + bwd read the gathered bf16
        # params (N / model_size per card post-gather)
        total += 2 * n_mb * 2 * (n / model) / data * 1  # land+read amortized
        # grad accumulate: read+write acc per microbatch
        total += 2 * n_mb * (4 if not huge else 2) * n_per_chip
    else:
        # serve: read the (active) bf16 params once
        act_n = cfg.active_param_count() if cfg.n_experts else n
        total += 2 * act_n / chips if shape.mode == "decode" \
            else 2 * n / chips

    # activations at layer boundaries (SP-sharded), save+read (+bwd)
    tok_local = tokens / (data * model)
    factor = 3 if shape.mode == "train" else 1
    total += factor * cfg.n_layers * tok_local * cfg.d_model * 2

    # attention score spill: dense attention materializes (S, S) scores
    # per local head; banded/window layers and chunked prefill stay in
    # on-chip tiles (no spill); decode reads the cache instead.
    n_global = (cfg.pattern.count("attn") * cfg.n_groups
                + cfg.tail_pattern.count("attn"))
    if shape.mode == "train" and n_global:
        h_local = max(1, cfg.n_heads / model)
        b_local = max(1, b / (data * n_mb))
        total += (factor * n_global * b_local * h_local * s * s * 2)
    if shape.mode in ("decode", "prefill"):
        # decode reads the whole KV cache / state once a step; prefill
        # writes it out
        total += cache_bytes_per_chip(cfg, shape, machine)

    # logits fwd(+bwd)
    v_local = cfg.padded_vocab / model
    tok_l = tokens / data / (n_mb if shape.mode == "train" else 1)
    total += factor * tok_l * v_local * 4 / (
        n_mb if shape.mode == "train" else 1)
    return total


def cache_bytes_per_chip(cfg: ModelConfig, shape, machine: Machine) -> float:
    b, s = shape.global_batch, shape.seq_len
    kv, hd = cfg.n_kv_heads, cfg.hd
    dtype = 1 if (cfg.n_kv_heads * cfg.hd * cfg.n_layers
                  >= 64 * 40 * 128) else 2
    total = 0.0
    n_local = (cfg.pattern.count("local") * cfg.n_groups
               + cfg.tail_pattern.count("local"))
    n_global = (cfg.pattern.count("attn") * cfg.n_groups
                + cfg.tail_pattern.count("attn"))
    n_rec = cfg.n_layers - n_local - n_global
    total += n_global * b * s * kv * hd * 2 * dtype
    if n_local:
        w = min(cfg.window or s, s)
        total += n_local * b * w * kv * hd * 2 * dtype
    if n_rec:  # mamba / rglru states
        if cfg.ssm_state:
            total += n_rec * b * cfg.ssm_heads * cfg.ssm_head_dim \
                * cfg.ssm_state * 4
        else:
            total += n_rec * b * (cfg.rnn_width or cfg.d_model) * 4
    return total / machine.chips


def terms_from_record(rec: dict, machine: Machine) -> dict:
    """Roofline terms (per card) of a dry-run record on ``machine``."""
    cfg = get_config(rec["arch"])
    meta = rec["single_pod"]["meta"]
    return terms(cfg, SHAPES[rec["shape"]], rec["analysis"]["extrapolated"],
                 optimizer=meta["optimizer"], n_mb=meta["n_microbatches"],
                 machine=machine)


def terms(cfg: ModelConfig, shape, ex: dict, *, optimizer: str, n_mb: int,
          machine: Machine) -> dict:
    """Roofline terms (per card) of one step of ``cfg`` at ``shape``
    whose per-card ``flops``, ``bytes`` and ``collectives`` are ``ex``."""
    chips, peak = machine.chips, machine.peak_flops
    huge = cfg.param_count() > 100e9

    flops = ex["flops"]                      # per card
    hlo_bytes = ex["bytes"]                  # per card (loose upper bound)
    coll = ex["collectives"].get("total_bf16_wire",
                                 ex["collectives"]["total"])
    mod_bytes = modeled_memory_bytes(cfg, shape, optimizer=optimizer,
                                     n_mb=n_mb, huge=huge, machine=machine)

    t_c = flops / peak
    t_m = mod_bytes / machine.hbm_bw
    t_m_hlo = hlo_bytes / machine.hbm_bw
    t_x = coll / machine.link_bw
    bound = max(t_c, t_m, t_x)
    dom = {t_c: "compute", t_m: "memory", t_x: "collective"}[bound]

    n_active = cfg.active_param_count()
    tokens = shape.global_batch * shape.seq_len
    if shape.mode == "train":
        model_flops = 6 * n_active * tokens
    elif shape.mode == "prefill":
        model_flops = 2 * n_active * tokens
    else:
        model_flops = 2 * n_active * shape.global_batch
    useful = model_flops / max(flops * chips, 1.0)

    # MFU-style score: model-useful FLOPs over the fleet's peak for the
    # bound duration (counts remat/dispatch waste AND the bound term)
    mfu = model_flops / (chips * peak * max(bound, 1e-30))

    return {
        "compute_s": t_c, "memory_s": t_m, "memory_s_hlo_bound": t_m_hlo,
        "collective_s": t_x, "bottleneck": dom, "bound_s": bound,
        "roofline_fraction": t_c / max(bound, 1e-30),
        "mfu_proxy": mfu,
        "model_flops": model_flops, "useful_ratio": useful,
        "coll_raw_s": ex["collectives"]["total"] / machine.link_bw,
        "flops_per_chip": flops, "coll_bytes_per_chip": coll,
        "modeled_bytes_per_chip": mod_bytes,
        "collective_mix": ex["collectives"],
        "collective_unverified": True,
    }
