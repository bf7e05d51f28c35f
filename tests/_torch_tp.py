"""Tensor and sequence parallelism of the port's sublayers (attention
and the MLP, ``repro_torch.models.blocks.attn_apply`` and ``mlp_apply``;
the mamba2 and RG-LRU mixers; whisper's encoder and cross-attention;
each with a rank's place, ``lm._sublayer``) against the reference's own
mesh run, shared by ``tests/test_torch_tp*.py``.

The reference runs in one subprocess (:func:`reference_main`) with 8
host devices on a (2, 4) ("data", "model") mesh of ``Auto`` axes (jax
0.9's ``make_mesh`` makes ``Explicit`` ones by default); the port runs on
8 gloo ranks on a (2, 4) ``DeviceMesh`` beside it
(``_torch_dist.tp_worker``), each rank on its own weight and cache
shards.  Both compute in float32 (``C`` set in both packages' model
modules) from the reference's initial weights and inputs drawn with
numpy from fixed seeds, under one profile (the (data, model) one, or
``pure_dp``: the batch over all 8 ranks, FSDP over both axes, no TP),
and train with the optimizers asked for.  The architectures:
stablelm-smoke (grouped K/V heads that do not split over 4 ranks: the
decode cache is cut by rows), qwen-smoke (4 K/V heads, QKV biases: cut
by heads) and gemma3-smoke (the banded local ring, cut by rows).
"""

import dataclasses
import os
import pathlib
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

import _torch_dist
import _torch_train

from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import lm as ref_lm
from repro.runtime.shardings import SMOKE
from repro.train.train_step import init_state as ref_init_state
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.models import lm
from repro_torch.runtime import shardings
from repro_torch.runtime.shardings import Profile, local_shard
from repro_torch.train.train_step import opt_specs
from repro_torch.tree import flatten_up_to, leaves

ROOT = pathlib.Path(__file__).resolve().parents[1]
DATA, MODEL = 2, 4
WORLD = DATA * MODEL
ARCHS = ("stablelm-12b", "qwen15-32b", "gemma3-27b")
# the other layer kinds: the mixers, the encoder and cross-attention,
# a patch prefix
KIND_ARCHS = ("mamba2-370m", "recurrentgemma-9b", "whisper-medium",
              "internvl2-26b")
# each arch's seed: its place here (a MoE config for Adafactor's
# expert leaves last)
SEEDED = ARCHS + KIND_ARCHS + ("deepseek-moe-16b",)
B, S = 4, 32                # the inputs' batch and sequence
MAX_SEQ = 48                # the decode cache's rows
LR = 1e-3
LAYER_REL = 1e-5            # relative L2 of the layer's output
F32_REL = 1e-4              # gradients, logits, caches, new parameters
F32_LOSS = 1e-5
# the 8 ranks' forward FLOPs against the dense forward's: each rank
# computes its share, mamba's B and C columns and C.B scores on every
# model rank
FLOPS_BOUND = 1.5


def _initial(cfg) -> dict:
    """The reference's initial weights of ``cfg`` (PRNGKey(1)), as
    numpy."""
    return jax.tree.map(np.asarray,
                        ref_lm.init_params(jax.random.PRNGKey(1), cfg))


def _states(params, optimizers) -> dict:
    """The reference's initial train state from ``params`` for each of
    ``optimizers``, as numpy."""
    return {opt: {k: jax.tree.map(np.asarray,
                                  getattr(ref_init_state(params, opt), k))
                  for k in ("params", "opt", "gv", "step")}
            for opt in optimizers}


def case_inputs(arch, parts, batch=B, optimizers=("adamw",),
                tied=False) -> dict:
    """The reference's initial weights (PRNGKey(1)) and the inputs of
    ``parts`` (``batch`` rows; with "train" an initial state for each
    of ``optimizers``, and where ``tied`` the same for the config with
    tied embeddings), as numpy, drawn from seeds fixed by the case."""
    cfg = ref_smoke_config(arch)
    rng = np.random.default_rng([SEEDED.index(arch), 7])
    params = _initial(cfg)
    tokens = rng.integers(0, cfg.vocab, (batch, S)).astype(np.int32)
    case = {"params": params, "lr": LR, "extra": {}, "tied": None}
    if cfg.encoder_layers:
        case["extra"]["frames"] = rng.standard_normal(
            (batch, cfg.n_frames, cfg.d_model)).astype(np.float32)
    if cfg.n_patches:
        case["extra"]["patches"] = rng.standard_normal(
            (batch, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if "layer" in parts:
        case["x"], case["ct"] = rng.standard_normal(
            (2, batch, S, cfg.d_model)).astype(np.float32)
    if "model" in parts:
        cache = ref_lm.init_cache(cfg, batch, MAX_SEQ, SMOKE)
        case.update(tokens=tokens, cache=jax.tree.map(
            lambda a: rng.standard_normal(a.shape).astype(np.float32),
            cache), dec_tokens=tokens[:, :1],
            pos=rng.integers(0, MAX_SEQ, (batch,)).astype(np.int32))
    if "train" in parts:
        case["states"] = _states(params, optimizers)
        case["batch"] = {"tokens": tokens,
                         "labels": np.roll(tokens, -1, axis=1),
                         **case["extra"]}
        if tied:
            tied_params = _initial(dataclasses.replace(
                cfg, tie_embeddings=True))
            case["tied"] = {"params": tied_params,
                            "states": _states(tied_params, optimizers)}
    return case


def reference_main(inputs, out):
    """The reference's calls on the (2, 4) mesh, under the pickled
    ``inputs``' profile keywords, for every one of its cases."""
    from jax.sharding import AxisType

    from repro.models import blocks, moe, rglru, ssm
    from repro.runtime.shardings import Profile
    from repro.train import make_train_step
    from repro.train.train_step import TrainState
    for m in (blocks, ref_lm, ssm, rglru, moe):
        m.C = jnp.float32
    mesh = jax.make_mesh((DATA, MODEL), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    with open(inputs, "rb") as f:
        inputs = pickle.load(f)
    prof = Profile(mesh=mesh, **inputs["profile"])
    # results come back replicated: jax 0.9 cannot name some of the
    # shardings GSPMD infers for the outputs on this mesh
    whole = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec())
    jit = lambda fn: jax.jit(fn, out_shardings=whole)

    def kw(p, extra, cfg):      # an encoder's output, a prefix
        out = {}
        if "frames" in extra:
            out["enc"] = ref_lm.encode(p, extra["frames"], cfg, prof,
                                       unroll=True)
        if "patches" in extra:
            out["prefix_embeds"] = extra["patches"]
        return out

    def pot_step(cfg, opt, initial, batch) -> dict:
        state = TrainState(**{k: jax.tree.map(jnp.asarray, v)
                              for k, v in initial.items()})
        step = jit(make_train_step(cfg, prof, optimizer=opt, mode="pot",
                                   n_microbatches=2, unroll=True, lr=LR))
        new, loss = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
        return dict(loss=float(loss), state={
            k: jax.tree.map(np.asarray, getattr(new, k))
            for k in ("params", "opt", "gv", "step")})

    result = {}
    with jax.set_mesh(mesh):
        for arch, case in inputs["cases"].items():
            cfg = ref_smoke_config(arch)
            params = jax.tree.map(jnp.asarray, case["params"])
            got = result[arch] = {}
            if "x" in case:
                kind = cfg.pattern[0]
                p = jax.tree.map(lambda a: a[0], params["layers"]["0"])
                x, ct = jnp.asarray(case["x"]), jnp.asarray(case["ct"])
                pos = jnp.broadcast_to(jnp.arange(S)[None],
                                       case["x"].shape[:2])

                def layer(p, x):
                    return ref_lm._sublayer(p, kind, x, cfg, prof,
                                            positions=pos)[0]
                y = jit(layer)(p, x)
                gp, gx = jit(jax.grad(
                    lambda p, x: (layer(p, x) * ct).sum(),
                    argnums=(0, 1)))(p, x)
                got["layer"] = dict(y=np.asarray(y), gx=np.asarray(gx),
                                    gp=jax.tree.map(np.asarray, gp))
            if "tokens" in case:
                tokens = jnp.asarray(case["tokens"])
                extra = {k: jnp.asarray(v) for k, v in case["extra"].items()}
                logits = jit(lambda p, t, e: ref_lm.forward(
                    p, t, cfg, prof, unroll=True, **kw(p, e, cfg)))(
                        params, tokens, extra)
                last, cache = jit(lambda p, t, e: ref_lm.prefill(
                    p, t, cfg, prof, max_seq=MAX_SEQ, unroll=True,
                    **kw(p, e, cfg)))(params, tokens, extra)
                dec, _ = jit(lambda p, c, t, po: ref_lm.decode_step(
                    p, c, t, po, cfg, prof, unroll=True))(
                    params, jax.tree.map(jnp.asarray, case["cache"]),
                    jnp.asarray(case["dec_tokens"]), jnp.asarray(case["pos"]))
                got["model"] = dict(logits=np.asarray(logits),
                                    prefill=np.asarray(last),
                                    cache=jax.tree.map(np.asarray, cache),
                                    decode=np.asarray(dec))
            got["train"] = {opt: pot_step(cfg, opt, initial, case["batch"])
                            for opt, initial in case.get("states",
                                                         {}).items()}
            if case["tied"]:
                tcfg = dataclasses.replace(cfg, tie_embeddings=True)
                tied = case["tied"]
                batch = {k: jnp.asarray(v) for k, v in case["batch"].items()}
                extra = {k: v for k, v in batch.items()
                         if k not in ("tokens", "labels")}
                logits = jit(lambda p, t, e: ref_lm.forward(
                    p, t, tcfg, prof, unroll=True, **kw(p, e, tcfg)))(
                        jax.tree.map(jnp.asarray, tied["params"]),
                        batch["tokens"], extra)
                got["tied"] = dict(logits=np.asarray(logits), train={
                    opt: pot_step(tcfg, opt, initial, case["batch"])
                    for opt, initial in tied["states"].items()})
    with open(out, "wb") as f:
        pickle.dump(result, f)


def run_both(tmp_path, parts, archs=ARCHS, *, batch=B,
             optimizers=("adamw",), tied=(), **profile) -> tuple[dict, list]:
    """The reference's subprocess and the port's 8 ranks side by side on
    the same inputs (``batch`` rows; with "train" a pot step with each
    of ``optimizers``, and for the archs of ``tied`` the forward and
    those pot steps with tied embeddings), both under the profile keywords
    ``profile``: (the reference's results by arch, each rank's)."""
    cases = {a: case_inputs(a, parts, batch, optimizers, a in tied)
             for a in archs}
    inputs, ref_out = tmp_path / "inputs.pkl", tmp_path / "ref.pkl"
    with open(inputs, "wb") as f:
        pickle.dump({"profile": profile, "cases": cases}, f)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")]),
        "XLA_FLAGS": f"--xla_force_host_platform_device_count={WORLD}",
        "JAX_PLATFORMS": "cpu"}
    ref = subprocess.Popen(
        [sys.executable, "-c", "import sys, _torch_tp as m; "
         "m.reference_main(sys.argv[1], sys.argv[2])", str(inputs),
         str(ref_out)], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        _torch_dist.spawn(_torch_dist.tp_worker, WORLD, tmp_path / "rdv",
                          str(inputs), str(tmp_path / "port"), parts)
    finally:
        _, err = ref.communicate(timeout=600)
    assert ref.returncode == 0, err[-3000:]
    with open(ref_out, "rb") as f:
        ref_result = pickle.load(f)
    ranks = []
    for r in range(WORLD):
        with open(tmp_path / f"port.{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return ref_result, ranks


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.linalg.norm(b)
    return float(np.linalg.norm(a - b) / (scale if scale else 1.0))


def same_bits(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


class CoordMesh:
    """What ``shardings.local_shard`` reads of the (DATA, MODEL) mesh at
    one coordinate, to cut a whole tree as that rank holds it in a
    process without the ranks."""

    mesh_dim_names = ("data", "model")
    shape = (DATA, MODEL)

    def __init__(self, coord):
        self.coord = tuple(coord)

    def get_coordinate(self):
        return list(self.coord)

    def size(self, dim=None):
        return DATA * MODEL if dim is None else self.shape[dim]


def profile(coord, **kw):
    return Profile(mesh=CoordMesh(coord), **kw)


def rank_profile(got):
    """The profile rank ``got`` (a rank's results) ran under, at its
    coordinate."""
    return profile(got["coord"], **got["profile"])


# ------------------------------------------------ the train step's checks
def expected(ref_state, cfg, prof) -> list:
    """The reference's new state as the leaves a rank under ``prof``
    holds: the port's tree order, each leaf cut to the rank's shard by
    its spec (``convert.train_state_from_numpy``)."""
    exp = convert.train_state_from_numpy(ref_state, cfg, "cpu", prof)
    return [t.numpy() for t in leaves([exp.params, exp.opt])]


def check_state(run, exp, cfg, prof, optimizer):
    """A pot step's loss and new state ``run`` against the reference's
    ``exp``, cut to the leaves a rank under ``prof`` holds.  AdamW's
    leaves with a cancelled gradient column
    (``_torch_train.undetermined``) are held through their moments."""
    want = expected(exp["state"], cfg, prof)
    n = len(leaves(convert.lm_params_from_numpy(
        exp["state"]["params"], cfg, "cpu", torch.float32)))
    np.testing.assert_allclose(run["loss"], exp["loss"], rtol=F32_LOSS)
    assert [a.shape for a in run["leaves"]] == [b.shape for b in want]
    skip = set() if optimizer != "adamw" else _torch_train.undetermined(
        run["leaves"][n:2 * n], want[n:2 * n])
    assert len(skip) <= cfg.n_layers, skip
    bad = {j: rel(a, b) for j, (a, b) in enumerate(zip(run["leaves"], want))
           if j not in skip and rel(a, b) > F32_REL}
    assert not bad, bad


def check_pot_step(runs, arch, optimizer="adamw"):
    """The rank's new state against the reference's
    (:func:`check_state`), and its delayed run bitwise the same (module
    docstrings of the train files)."""
    ref_result, ranks = runs
    exp = ref_result[arch]["train"][optimizer]
    cfg = get_smoke_config(arch)
    for got in ranks:
        run, delayed = got[arch]["train"][optimizer]
        assert run["counters"] == [1, 1]
        check_state(run, exp, cfg, rank_profile(got), optimizer)
        assert same_bits(run["loss"], delayed["loss"])
        assert all(same_bits(a, b) for a, b in zip(
            run["leaves"], delayed["leaves"], strict=True))


def blocks(state, cfg, prof, optimizer) -> list:
    """Which block of each leaf of a whole ``state`` (the port's tree
    order) a rank under ``prof`` holds: the indices of its shard
    (``local_shard`` of the leaf's element indices by its spec, the
    statistics' by ``train_step.opt_specs``), as bytes."""
    pspecs = lm.param_specs(cfg, prof)
    tree = [state.params, state.opt]
    specs = flatten_up_to(tree, [pspecs, opt_specs(pspecs, state.params,
                                                   optimizer, cfg)])
    return [local_shard(torch.arange(t.numel()).reshape(t.shape), spec,
                        prof.mesh).numpy().tobytes()
            for t, spec in zip(leaves(tree), specs, strict=True)]


def check_same_on_every_rank(runs, arch, optimizer="adamw"):
    """The loss bitwise the same on every rank, and each leaf and
    statistic bitwise the same on every rank that holds the same block
    of it (the whole on all of them where its spec cuts nothing)."""
    ref_result, ranks = runs
    cfg = get_smoke_config(arch)
    exp = ref_result[arch]["train"][optimizer]["state"]
    whole = convert.train_state_from_numpy(exp, cfg, device="cpu")
    first = ranks[0][arch]["train"][optimizer][0]
    held, shared = {}, 0
    for got in ranks:
        run = got[arch]["train"][optimizer][0]
        assert same_bits(run["loss"], first["loss"])
        for j, (a, block) in enumerate(zip(run["leaves"], blocks(
                whole, cfg, rank_profile(got), optimizer), strict=True)):
            if (j, block) in held:
                assert same_bits(a, held[(j, block)]), j
                shared += 1
            else:
                held[(j, block)] = a
    assert shared


# ------------------------------------------------ the model's checks
def check_forward_and_prefill(runs, arch):
    """``lm.forward``, ``lm.prefill`` and the rank's cache shard against
    the reference's mesh run, the same on every rank."""
    ref_result, ranks = runs
    exp = ref_result[arch]["model"]
    cfg = get_smoke_config(arch)
    whole = convert.lm_cache_from_numpy(exp["cache"], cfg, "cpu",
                                        torch.float32)
    for got in ranks:
        model = got[arch]["model"]
        assert rel(model["logits"], exp["logits"]) <= F32_REL
        assert rel(model["prefill"], exp["prefill"]) <= F32_REL
        want = lm.local_cache(whole, cfg, rank_profile(got))
        assert len(model["cache"]) == len(want)
        for mine, cut in zip(model["cache"], want):
            assert set(mine) == set(cut)
            for name, t in cut.items():
                assert mine[name].shape == tuple(t.shape), name
                assert rel(mine[name], t.numpy()) <= F32_REL, name
        for key in ("logits", "prefill"):
            assert same_bits(model[key], ranks[0][arch]["model"][key])


def check_forward_flops(runs, arch):
    """The ranks' ``lm.forward`` FLOPs (whisper's ``lm.encode`` included)
    sum to at least the dense forward's over the whole batch and at most
    ``FLOPS_BOUND`` times it: no rank computes a layer whole."""
    _, ranks = runs
    dense = {got[arch]["model"]["flops"][1] for got in ranks}
    assert len(dense) == 1, dense
    dense = dense.pop()
    total = sum(got[arch]["model"]["flops"][0] for got in ranks)
    assert dense <= total <= FLOPS_BOUND * dense, (total, dense)


def check_decode_step(runs, arch):
    """One ``decode_step`` against the reference's, the same on every
    rank."""
    ref_result, ranks = runs
    exp = ref_result[arch]["model"]
    for got in ranks:
        model = got[arch]["model"]
        assert rel(model["decode"], exp["decode"]) <= F32_REL
        assert same_bits(model["decode"], ranks[0][arch]["model"]["decode"])


def check_session(runs, arch):
    """A ``Session``'s tokens (one row a slot: the case's batch, as the
    reference's logits have it) and fingerprint the same on every
    rank."""
    ref_result, ranks = runs
    first = ranks[0][arch]["model"]
    rows = len(ref_result[arch]["model"]["logits"])
    assert first["session"].shape == (rows, 5)
    for got in ranks[1:]:
        model = got[arch]["model"]
        assert same_bits(model["session"], first["session"])
        assert model["fingerprint"] == first["fingerprint"]


def check_tied(runs, arch, path):
    """Tied embeddings (``_torch_dist._tp_tied``; ``path`` "mesh": on the
    rank's shards, "dense": whole on the rank, no profile) against the
    reference's mesh run of the tied config: the logits within 1e-4 in
    relative L2 and each optimizer's pot step as :func:`check_state`
    holds it."""
    ref_result, ranks = runs
    exp = ref_result[arch]["tied"]
    cfg = dataclasses.replace(get_smoke_config(arch), tie_embeddings=True)
    for got in ranks:
        run = got[arch]["tied"][path]
        assert rel(run["logits"], exp["logits"]) <= F32_REL
        assert set(run["train"]) == set(exp["train"])
        for opt, step in run["train"].items():
            check_state(step, exp["train"][opt], cfg,
                        rank_profile(got) if path == "mesh"
                        else shardings.SMOKE, opt)
