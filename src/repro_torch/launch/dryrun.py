"""Multi-card dry run of every architecture x shape cell on the ``meta``
device, after ``repro.launch.dryrun``.

    python -m repro_torch.launch.dryrun --cards 64 --link-bw 4.5e11

For every cell (``configs.SHAPES``; the 8 full-attention ``long_500k``
cells are documented skips) this builds the real step on the ``meta``
device at full width and depth (shapes and dtypes, no values, no
memory) and writes one JSON record per cell under ``results/
torch_dryrun/`` with the reference's keys where they have a
counterpart.  The reference compiles each cell with XLA on a host mesh
and reads the compiler's cost and memory analyses; here:

* **FLOPs** -- ``torch.utils.flop_counter.FlopCounterMode`` over the
  step: forward and backward of ``train.loss_fn`` with ``remat=True``
  (the recomputed forward counted) for one microbatch, times the
  microbatches; ``lm.prefill`` (after ``lm.encode`` for whisper) or one
  ``lm.decode_step`` otherwise.  The layer loop is Python, so the count
  is of the full depth, exactly; :func:`extrapolate` is kept and held
  against it by the tests.  Per card: the count over the cards.
* **Bytes** -- a dispatch mode sums the bytes of every op's tensor
  inputs and outputs: nothing is fused, so a loose upper bound on HBM
  traffic (XLA:CPU's ``bytes accessed`` in the reference).  Per card:
  over the cards.  ``roofline_model.modeled_memory_bytes`` stays the
  primary memory term.
* **Memory fit** -- per card, from the spec trees at the mesh
  (``lm.param_specs``, ``lm.cache_specs``, :func:`opt_specs`; each leaf
  takes its largest local shard): parameters P, the float32 gradient
  sum G (the step's own gradients, Gm, in the parameters' dtype), the
  optimizer state O and the activations A saved for backward
  (``torch.autograd.graph.saved_tensors_hooks`` on ``meta``; with remat
  the layers' inputs and what lies outside the layers), divided over the
  cards the batch and sequence dims are spread over.  The port's step
  is functional, so at the optimizer apply the old and the new
  parameters and state coexist:

      train peak = max(P + O + G + Gm + A, 2 P + 2 O + G)
                   (G = 0 with one microbatch)
      serve peak = P + cache + the largest op output

  against ``CARD_BYTES`` (the H100's 80 GB).
* **Collective bytes** -- from the spec trees, wire bytes per card of
  ring collectives over a group of g cards: an all-gather or a
  reduce-scatter of X gathered bytes moves (g - 1) / g X, an all-reduce
  2 (g - 1) / g X, an all-to-all (g - 1) / g X.  Per step:

      FSDP gather, each leaf over its data axes (g_f), bf16, forward and
          backward of every microbatch:  2 n_mb (g_f - 1) / g_f W_leaf
      gradient reduce-scatter over those axes, float32, per microbatch:
          n_mb (g_f - 1) / g_f W32_leaf
      gradient all-reduce over the batch axes the leaf is replicated on
          (g_r), float32, once:  2 (g_r - 1) / g_r L32_leaf
      model-axis activations (m = model size; none under ``pure_dp``):
          each sublayer (mixer, cross-attention, MLP or MoE) all-gathers
          its (B/d, S, D) bf16 input and reduce-scatters its output, in
          each pass (train: forward, remat's forward, backward; serve:
          one):  passes n_mb n_sub 2 (m - 1) / m (B/d) S D 2
      MoE all-to-all over the model axis (experts), dispatch and
          combine of the k cf (B/d) S tokens' rows, each pass:
          passes n_mb n_moe 2 (m - 1) / m k cf (B/d) S D 2

  where W_leaf is the leaf's bytes sharded over the model axis only,
  L32 its local gradient shard, d the batch's shard count (B/d per
  microbatch) and S 1 in decode.  One card cannot measure its link
  rate, so every record marks the collective term unverified.

``choose_optimizer``, ``choose_chunk``, ``choose_microbatches`` and
``_cache_dtype`` (fp8 for the widest caches) are the reference's.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
from functools import partial

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCHS, LONG_OK, SHAPES, get_config
from repro_torch.launch import roofline_model
from repro_torch.launch.mesh import NVLINK_DOMAIN, production_mesh_shape
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.runtime.shardings import P, Profile, local_shape, norm_spec
from repro_torch.train.train_step import _value_and_grad, init_state, loss_fn
from repro_torch.tree import flatten_up_to, leaves

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "torch_dryrun")
CARD_BYTES = 80e9   # an H100's HBM

BF16 = torch.bfloat16
F32 = torch.float32


# --------------------------------------------------------------- helpers
def _zip_map(fn, spec, like):
    """``fn(spec_leaf, like_subtree)`` over a spec tree, keeping its
    structure; ``like`` holds the spec tree's structure (dicts by key)."""
    if isinstance(spec, P):
        return fn(spec, like)
    if isinstance(spec, dict):
        return {k: _zip_map(fn, s, like[k]) for k, s in spec.items()}
    return [_zip_map(fn, s, x) for s, x in zip(spec, like, strict=True)]


def _lead(spec_tree):
    """Every spec of the tree with a leading ``None``: the stacked group
    axis of a pattern slot."""
    return _zip_map(lambda s, _: P(None, *s), spec_tree, spec_tree)


def opt_specs(pspecs, params, optimizer: str, cfg: ModelConfig) -> dict:
    """The spec tree of the optimizer state (``train.init_state``).
    AdamW: the moments by the parameters' specs.  Adafactor: the
    statistics in their stacked layout (``optim/adafactor.py``), each
    pattern slot's specs with the group axis in front, a factored leaf's
    ``vr`` and ``vc`` its spec without the last and without the second
    last dim, as the reference's."""
    if optimizer == "adamw":
        return {"m": pspecs, "v": pspecs, "step": P()}

    def leaf(spec, ndim):
        t = norm_spec(spec, ndim)
        if ndim >= 2:
            return {"vr": P(*t[:-1]), "vc": P(*(t[:-2] + t[-1:]))}
        return {"v": spec}

    def plain(spec_tree, like, stacked):
        return _zip_map(lambda s, p: leaf(s, p.ndim + stacked), spec_tree,
                        like)

    stats = {}
    for k, s in pspecs.items():
        if k == "layers":
            slots = len(cfg.pattern)
            n_grouped = len(s) - len(cfg.tail_pattern)
            stats[k] = {str(i): plain(_lead(s[i]), params[k][i], 1)
                        for i in range(slots)}
            if cfg.tail_pattern:
                stats["tail"] = {str(j): plain(s[n_grouped + j],
                                               params[k][n_grouped + j], 0)
                                 for j in range(len(cfg.tail_pattern))}
        elif k == "enc_layers":
            stats[k] = plain(_lead(s[0]), params[k][0], 1)
        else:
            stats[k] = leaf(s, params[k].ndim)
    return {"stats": stats, "step": P()}


def profile_for(sizes: dict, shape_spec) -> Profile:
    """The reference's profile of a mesh of ``sizes`` (axis -> size)."""
    data_axes = ("pod", "data") if "pod" in sizes else ("data",)
    n_data = math.prod(sizes[a] for a in data_axes)
    replicated = shape_spec.global_batch % n_data != 0
    return Profile(data_axes=data_axes, model_axis="model",
                   replicated_batch=replicated)


def choose_optimizer(cfg: ModelConfig) -> str:
    return "adafactor" if cfg.param_count() > 100e9 else "adamw"


def choose_chunk(cfg: ModelConfig, seq_len: int) -> int:
    # q-chunked attention for long global-attention sequences
    return 2048 if seq_len > 8192 and any(
        k == "attn" for k in cfg.pattern + cfg.tail_pattern) else 0


def choose_microbatches(cfg: ModelConfig, shape, n_data: int = 16) -> int:
    if shape.mode != "train":
        return 1
    n = cfg.param_count()
    cap = max(1, shape.global_batch // n_data)  # keep B_mb >= data shards
    if n > 100e9:
        return min(8, cap)
    if n > 18e9:
        return min(8, cap)
    if n > 8e9:
        return min(4, cap)
    return 1


def _cache_dtype(cfg: ModelConfig):
    # fp8 KV cache for MHA-at-32k archs whose bf16 cache exceeds HBM
    if cfg.n_kv_heads * cfg.hd * cfg.n_layers >= 64 * 40 * 128:
        return torch.float8_e4m3fn
    return BF16


def depth_units(cfg: ModelConfig) -> float:
    """Number of pattern groups incl. the tail as a fraction."""
    g = len(cfg.pattern)
    return cfg.n_groups + len(cfg.tail_pattern) / g


def extrapolate(s1: dict, s2: dict, units: float) -> dict:
    """total = cost(1 group) + (units - 1) * (cost(2g) - cost(1g))."""
    out = {}
    for key in ("flops", "bytes"):
        delta = s2[key] - s1[key]
        out[key] = s1[key] + (units - 1) * delta
    coll = {}
    for k in s1["collectives"]:
        delta = s2["collectives"][k] - s1["collectives"][k]
        coll[k] = s1["collectives"][k] + (units - 1) * delta
    out["collectives"] = coll
    return out


# -------------------------------------------------------------- counting
class _OpBytes(TorchDispatchMode):
    """The bytes of every op's tensor inputs and outputs, and the largest
    output."""

    def __init__(self):
        super().__init__()
        self.total = 0
        self.largest = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ins = [t for t in leaves([list(args), kwargs or {}])
               if isinstance(t, torch.Tensor)]
        outs = [t for t in leaves(out) if isinstance(t, torch.Tensor)]
        size = lambda t: t.numel() * t.element_size()
        self.total += sum(map(size, ins)) + sum(map(size, outs))
        self.largest = max([self.largest] + [size(t) for t in outs])
        return out


def count(fn, exclude=()) -> dict:
    """Run ``fn()`` and count its FLOPs, its ops' bytes, its largest op
    output and the bytes of the distinct storages saved for backward
    (those of the tensors in ``exclude``, the parameters, left out)."""
    skip = {t.untyped_storage()._cdata for t in exclude}
    seen = set()
    saved = 0

    def pack(t):
        nonlocal saved
        key = t.untyped_storage()._cdata
        if key not in skip and key not in seen:
            seen.add(key)
            saved += t.untyped_storage().nbytes()
        return t

    flops = FlopCounterMode(display=False)
    ops = _OpBytes()
    with flops, ops, torch.autograd.graph.saved_tensors_hooks(
            pack, lambda t: t):
        fn()
    return {"flops": float(flops.get_total_flops()), "bytes": float(ops.total),
            "saved_bytes": float(saved), "largest_bytes": float(ops.largest)}


def make_inputs(cfg: ModelConfig, mode: str, batch: int, seq: int,
                device) -> dict:
    """The step's inputs of ``batch`` rows (zeros): ``tokens`` and
    ``labels`` (train) of ``seq`` positions less the patches, whisper's
    ``frames`` and internvl2's ``patches`` in bf16; decode's one token a
    row and its ``pos``."""
    zeros = partial(torch.zeros, device=device)
    if mode == "decode":
        return {"tokens": zeros((batch, 1), dtype=torch.int64),
                "pos": zeros((batch,), dtype=torch.int64)}
    s_text = seq - (cfg.n_patches or 0)
    out = {"tokens": zeros((batch, s_text), dtype=torch.int64)}
    if mode == "train":
        out["labels"] = zeros((batch, s_text), dtype=torch.int64)
    if cfg.encoder_layers:
        out["frames"] = zeros((batch, cfg.n_frames, cfg.d_model), dtype=BF16)
    if cfg.n_patches:
        out["patches"] = zeros((batch, cfg.n_patches, cfg.d_model),
                               dtype=BF16)
    return out


def count_cell(cfg: ModelConfig, shape, params, *, n_mb: int = 1,
               chunk: int = 0) -> dict:
    """:func:`count` of one step of ``cfg`` at ``shape`` (a ``ShapeSpec``)
    over ``params`` on their device: train one microbatch's forward and
    backward with remat (FLOPs and bytes times ``n_mb``), prefill or one
    decode step.  The inputs are :func:`make_inputs`' zeros."""
    device = leaves(params)[0].device
    b, s = shape.global_batch, shape.seq_len
    if shape.mode == "train":
        batch = make_inputs(cfg, "train", b // n_mb, s, device)
        loss = partial(loss_fn, cfg=cfg, chunk=chunk, remat=True)
        out = count(lambda: _value_and_grad(loss, params, batch),
                    exclude=leaves(params))
        out["flops"] *= n_mb
        out["bytes"] *= n_mb
        return out
    batch = make_inputs(cfg, shape.mode, b, s, device)
    if shape.mode == "prefill":
        def step():
            enc = (lm.encode(params, batch["frames"], cfg)
                   if cfg.encoder_layers else None)
            return lm.prefill(params, batch["tokens"], cfg, max_seq=s,
                              prefix_embeds=batch.get("patches"), enc=enc,
                              chunk=chunk)
    else:
        cache = lm.init_cache(cfg, b, s, device, dtype=_cache_dtype(cfg))

        def step():
            return lm.decode_step(params, cache, batch["tokens"],
                                  batch["pos"], cfg)
    with torch.no_grad():
        return count(step)


# ------------------------------------------------------------ per card
def _local_bytes(t, spec, sizes: dict, dtype=None) -> int:
    elem = (torch.empty((), dtype=dtype).element_size() if dtype
            else t.element_size())
    return math.prod(local_shape(tuple(t.shape), spec, sizes)) * elem


def tree_local_bytes(tree, specs, sizes: dict, dtype=None) -> int:
    """Per-card bytes of a tensor tree laid out by its spec tree."""
    return sum(_local_bytes(t, s, sizes, dtype)
               for t, s in zip(leaves(tree), flatten_up_to(tree, specs),
                               strict=True))


def _axes_of(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def batch_shards(prof: Profile, sizes: dict) -> int:
    return math.prod(sizes[a] for a in _axes_of(prof.da))


def act_shards(prof: Profile, sizes: dict) -> int:
    """The cards a (B, S, D) activation at a layer boundary spreads over."""
    seq = sizes[prof.ma] if (prof.seq_shard and prof.ma) else 1
    return batch_shards(prof, sizes) * seq


def _ring(g: int, nbytes: float, factor: int = 1) -> float:
    return factor * (g - 1) / g * nbytes if g > 1 else 0.0


def collective_bytes(cfg: ModelConfig, shape, params, pspecs, prof: Profile,
                     sizes: dict, n_mb: int) -> dict:
    """Wire bytes per card of one step (module docstring's formulas)."""
    out = {"all-gather": 0.0, "all-reduce": 0.0, "reduce-scatter": 0.0,
           "all-to-all": 0.0, "collective-permute": 0.0, "ops": 0}
    train = shape.mode == "train"
    data_axes = set(_axes_of(prof._fs(0)))
    batch_axes = set(_axes_of(prof.da))
    model_only = {prof.model_axis: sizes[prof.model_axis]}
    if train:
        for t, spec in zip(leaves(params), flatten_up_to(params, pspecs),
                           strict=True):
            used = {a for e in norm_spec(spec, t.ndim) for a in _axes_of(e)}
            g_f = math.prod(sizes[a] for a in used & data_axes)
            g_r = math.prod(sizes[a] for a in batch_axes - used)
            kept = P(*(e if set(_axes_of(e)) <= {prof.model_axis} else None
                       for e in norm_spec(spec, t.ndim)))
            w = _local_bytes(t, kept, model_only, BF16)
            w32 = _local_bytes(t, kept, model_only, F32)
            if g_f > 1:
                out["all-gather"] += _ring(g_f, w, 2 * n_mb)
                out["reduce-scatter"] += _ring(g_f, w32, n_mb)
                out["ops"] += 3 * n_mb
            if g_r > 1:
                out["all-reduce"] += _ring(
                    g_r, _local_bytes(t, spec, sizes, F32), 2)
                out["ops"] += 1
    m = 1 if prof.ma is None else sizes[prof.ma]
    if m > 1:
        kinds = lm.layer_kinds(cfg)
        n_sub = sum(1 + (k != "mamba" and cfg.mlp != "none")
                    + bool(cfg.encoder_layers) for k in kinds)
        n_sub += 2 * cfg.encoder_layers
        n_moe = (sum(k != "mamba" for k in kinds) if cfg.n_experts
                 and cfg.mlp != "none" else 0)
        passes = (3 if train else 1) * n_mb
        s = 1 if shape.mode == "decode" else shape.seq_len
        rows = shape.global_batch / n_mb / batch_shards(prof, sizes) * s
        act = rows * cfg.d_model * 2
        out["all-gather"] += passes * n_sub * _ring(m, act)
        out["reduce-scatter"] += passes * n_sub * _ring(m, act)
        out["all-to-all"] += passes * n_moe * _ring(
            m, act * cfg.top_k * cfg.capacity_factor, 2)
        out["ops"] += passes * (2 * n_sub + 2 * n_moe)
    out["total"] = sum(v for k, v in out.items() if k not in ("ops",))
    out["total_bf16_wire"] = out["total"]
    return out


def memory_per_card(cfg: ModelConfig, shape, params, pspecs, prof: Profile,
                    sizes: dict, counts: dict, *, optimizer: str,
                    n_mb: int) -> dict:
    """Per-card bytes of the step (module docstring's model)."""
    p = tree_local_bytes(params, pspecs, sizes)
    out = {"param_bytes": p}
    acts = counts["saved_bytes"] / act_shards(prof, sizes)
    if shape.mode == "train":
        opt = init_state(params, optimizer, cfg=cfg).opt
        o = tree_local_bytes(opt, opt_specs(pspecs, params, optimizer, cfg),
                             sizes)
        gm = p
        g = tree_local_bytes(params, pspecs, sizes, F32) if n_mb > 1 else 0
        peak = max(p + o + g + gm + acts, 2 * p + 2 * o + g)
        out.update(grad_bytes=g + gm, opt_bytes=o, activation_bytes=acts)
    else:
        cache = lm.init_cache(cfg, shape.global_batch, shape.seq_len, "meta",
                              dtype=_cache_dtype(cfg))
        c = tree_local_bytes(cache, lm.cache_specs(cfg, prof,
                                                   sizes[prof.model_axis]),
                             sizes)
        largest = counts["largest_bytes"] / act_shards(prof, sizes)
        peak = p + c + largest
        out.update(cache_bytes=c, largest_op_bytes=largest)
    out.update(peak_bytes=peak, capacity_bytes=CARD_BYTES,
               fits=bool(peak <= CARD_BYTES))
    return out


# ------------------------------------------------------------ cell build
def _mesh_record(cfg, shape, params, counts, *, n_cards, multi_pod,
                 optimizer, chunk, n_mb, arch, shape_name):
    mesh_shape, axes = production_mesh_shape(n_cards, multi_pod)
    sizes = dict(zip(axes, mesh_shape))
    prof = profile_for(sizes, shape)
    pspecs = lm.param_specs(cfg, prof)
    meta = {"arch": arch, "shape": shape_name,
            "mesh": "x".join(map(str, mesh_shape)), "mode": shape.mode,
            "optimizer": optimizer, "n_microbatches": n_mb, "chunk": chunk,
            "n_groups": None, "train_mode": "pot", "n_chips": n_cards}
    return {
        "meta": meta,
        "flops": counts["flops"] / n_cards,
        "bytes": counts["bytes"] / n_cards,
        "collectives": collective_bytes(cfg, shape, params, pspecs, prof,
                                        sizes, n_mb),
        "memory": memory_per_card(cfg, shape, params, pspecs, prof, sizes,
                                  counts, optimizer=optimizer, n_mb=n_mb),
        "n_chips": n_cards,
    }


def run_cell(arch: str, shape_name: str, *, n_cards: int, link_bw: float,
             with_multipod: bool = True, out_dir=None) -> dict:
    """Count one cell on ``meta`` and write its record."""
    out_dir = out_dir or RESULTS_DIR
    os.makedirs(out_dir, exist_ok=True)
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    optimizer = choose_optimizer(cfg)
    chunk = choose_chunk(cfg, shape.seq_len)
    # >100B params: bf16 master params (the reference's budget at that
    # scale); serving runs on bf16 weights
    huge = cfg.param_count() > 100e9
    dtype = F32 if shape.mode == "train" and not huge else BF16
    t0 = time.perf_counter()
    params = lm.init_params(None, cfg, dtype=dtype, device="meta")
    # both meshes hold n / 8 data shards (single pod n/8 x 8, multi-pod
    # 2 x n/16 x 8), so one microbatch count serves both
    n_mb = choose_microbatches(cfg, shape, n_cards // NVLINK_DOMAIN)
    counts = count_cell(cfg, shape, params, n_mb=n_mb, chunk=chunk)
    rec = {"arch": arch, "shape": shape_name, "mode": shape.mode,
           "param_elements": sum(t.numel() for t in leaves(params)),
           "count": counts}
    kw = dict(n_cards=n_cards, optimizer=optimizer, chunk=chunk, n_mb=n_mb,
              arch=arch, shape_name=shape_name)
    rec["single_pod"] = sp = _mesh_record(cfg, shape, params, counts,
                                          multi_pod=False, **kw)
    if with_multipod and n_cards % (2 * NVLINK_DOMAIN) == 0:
        rec["multi_pod"] = _mesh_record(cfg, shape, params, counts,
                                        multi_pod=True, **kw)
    sp["meta"]["count_s"] = round(time.perf_counter() - t0, 2)
    rec["analysis"] = {"depth_units": depth_units(cfg), "full_depth": True,
                       "extrapolated": {"flops": sp["flops"],
                                        "bytes": sp["bytes"],
                                        "collectives": sp["collectives"]}}
    rec["roofline"] = roofline_model.terms_from_record(
        rec, roofline_model.h100(n_cards, link_bw=link_bw))
    path = os.path.join(out_dir, f"{arch}__{shape_name}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    mem = sp["memory"]
    print(f"  {arch}/{shape_name}: {sp['flops']:.4e} FLOP/card, peak "
          f"{mem['peak_bytes'] / 1e9:.2f} GB/card at {sp['meta']['mesh']}"
          f" ({'fits' if mem['fits'] else 'does not fit'}), bound "
          f"{rec['roofline']['bound_s']:.4e} s "
          f"({rec['roofline']['bottleneck']}) -> {path}", flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--cards", type=int, default=64,
                    help="cards of the single-pod mesh (a multiple of 8)")
    ap.add_argument("--link-bw", type=float, required=True,
                    help="interconnect bytes/s per card (unverified: one "
                         "card cannot measure it)")
    ap.add_argument("--no-multipod", action="store_true")
    ap.add_argument("--out-dir", default=None)
    args = ap.parse_args(argv)

    archs = ARCHS if args.arch == "all" else [args.arch.replace("-", "_")]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    t0 = time.time()
    done, skipped = 0, 0
    for arch in archs:
        for shape_name in shapes:
            if shape_name == "long_500k" and arch not in LONG_OK:
                print(f"SKIP {arch}/{shape_name}: full-attention arch, "
                      "500k exceeds design envelope")
                skipped += 1
                continue
            print(f"[{time.time() - t0:7.0f}s] CELL {arch}/{shape_name}",
                  flush=True)
            run_cell(arch, shape_name, n_cards=args.cards,
                     link_bw=args.link_bw,
                     with_multipod=not args.no_multipod,
                     out_dir=args.out_dir)
            done += 1
    print(f"DONE: {done} cells counted, {skipped} documented skips, "
          f"{time.time() - t0:.0f}s total")


if __name__ == "__main__":
    main()
