"""Expert parallelism of the port's MoE layer (``repro_torch.models.moe``)
against the reference's ``_moe_shardmap`` GShard schedule, shared by
``tests/test_torch_moe_ep*.py``.

The reference runs in one subprocess (:func:`reference_main`) with 8
host devices on a (2, 4) ("data", "model") mesh of ``Auto`` axes (jax
0.9's ``make_mesh`` makes ``Explicit`` ones by default, which the shared
expert's sharding constraint rejects); the port runs on 8 gloo ranks on
a (2, 4) ``DeviceMesh`` beside it (``_torch_dist.moe_ep_worker``), each
rank on its own expert shards.  Both compute in float32 (``C`` set in
both packages' model modules), from the reference's initial weights and
inputs drawn with numpy from fixed seeds, at the smoke configuration's
capacity factor and at 1.0, where each block (a rank's tokens) drops
its own: the dense path is no oracle there, the reference's mesh run is.
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

import _torch_dist

from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import lm as ref_lm
from repro.runtime.shardings import SMOKE
from repro.train.train_step import init_state as ref_init_state

ROOT = pathlib.Path(__file__).resolve().parents[1]
DATA, MODEL = 2, 4
WORLD = DATA * MODEL
ARCHS = ("deepseek-moe-16b", "arctic-480b")
CFS = (None, 1.0)           # the smoke configuration's, then drops
B, S = 4, 32                # the layer's input and lm.forward's tokens
MAX_SEQ = 16                # the decode cache's rows
LR = 1e-3
LAYER_REL = 1e-5            # relative L2 of the layer's output
F32_REL = 1e-4              # gradients, logits, new parameters
F32_LOSS = 1e-5
EXPERTS = ("w1", "w3", "w2")


def ref_config(arch, cf):
    cfg = ref_smoke_config(arch)
    return cfg if cf is None else dataclasses.replace(cfg,
                                                      capacity_factor=cf)


def case_inputs(arch, cf, parts) -> dict:
    """The reference's initial weights (PRNGKey(1)) and the inputs of
    ``parts``, as numpy, drawn from seeds fixed by the case."""
    cfg = ref_config(arch, cf)
    rng = np.random.default_rng([ARCHS.index(arch), CFS.index(cf)])
    params = jax.tree.map(np.asarray,
                          ref_lm.init_params(jax.random.PRNGKey(1), cfg))
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    case = {"params": params, "lr": LR}
    if "layer" in parts:
        case["x"], case["ct"] = rng.standard_normal(
            (2, B, S, cfg.d_model)).astype(np.float32)
    if "model" in parts:
        cache = ref_lm.init_cache(cfg, B, MAX_SEQ, SMOKE)
        case.update(tokens=tokens, cache=jax.tree.map(
            lambda a: rng.standard_normal(a.shape).astype(np.float32),
            cache), dec_tokens=tokens[:, :1],
            pos=rng.integers(0, MAX_SEQ, (B,)).astype(np.int32))
    if "train" in parts:
        s = ref_init_state(params, "adamw")
        case["state"] = {k: jax.tree.map(np.asarray, getattr(s, k))
                         for k in ("params", "opt", "gv", "step")}
        case["batch"] = {"tokens": tokens,
                         "labels": np.roll(tokens, -1, axis=1)}
    return case


def reference_main(inputs, out):
    """The reference's calls on the (2, 4) mesh for every case of the
    pickled ``inputs``; each routing recorded per (call, data, model)
    block from inside its ``shard_map``."""
    from jax.sharding import AxisType

    from repro.models import blocks, moe, rglru, ssm
    from repro.runtime.shardings import Profile
    from repro.train import make_train_step
    from repro.train.train_step import TrainState
    for m in (blocks, ref_lm, ssm, rglru, moe):
        m.C = jnp.float32
    mesh = jax.make_mesh((DATA, MODEL), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    prof = Profile(mesh=mesh)
    routing, calls = {}, [0]
    route = moe._route_and_dispatch

    def recording(xt, router, e, k, cf):
        out = route(xt, router, e, k, cf)
        call = calls[0]
        calls[0] += 1

        def save(d, m, eidx, keep):
            routing[(call, int(d), int(m))] = (np.asarray(eidx).copy(),
                                               np.asarray(keep).copy())
        jax.debug.callback(save, jax.lax.axis_index("data"),
                           jax.lax.axis_index("model"), out[1], out[3])
        return out
    moe._route_and_dispatch = recording

    def recorded(fn, *args):
        routing.clear()
        calls[0] = 0
        out = jax.block_until_ready(fn(*args))
        jax.effects_barrier()
        return out, dict(routing)

    with open(inputs, "rb") as f:
        cases = pickle.load(f)
    result = {}
    with jax.set_mesh(mesh):
        for (arch, cf), case in cases.items():
            cfg = ref_config(arch, cf)
            params = jax.tree.map(jnp.asarray, case["params"])
            got = result[(arch, cf)] = {}
            if "x" in case:
                p = jax.tree.map(lambda a: a[0], params["layers"]["0"]["moe"])
                x, ct = jnp.asarray(case["x"]), jnp.asarray(case["ct"])
                y, rec = recorded(jax.jit(
                    lambda p, x: moe.moe_apply(p, x, cfg, prof)), p, x)
                gp, gx = jax.jit(jax.grad(
                    lambda p, x: (moe.moe_apply(p, x, cfg, prof) * ct).sum(),
                    argnums=(0, 1)))(p, x)
                got["layer"] = dict(
                    y=np.asarray(y), routing=rec, grads=dict(
                        x=np.asarray(gx), router=np.asarray(gp["router"]),
                        **{n: np.asarray(gp[n]) for n in EXPERTS}))
            if "tokens" in case:
                tokens = jnp.asarray(case["tokens"])
                logits, frec = recorded(jax.jit(
                    lambda p, t: ref_lm.forward(p, t, cfg, prof,
                                                unroll=True)), params, tokens)
                (dec, _), drec = recorded(jax.jit(
                    lambda p, c, t, po: ref_lm.decode_step(
                        p, c, t, po, cfg, prof, unroll=True)),
                    params, jax.tree.map(jnp.asarray, case["cache"]),
                    jnp.asarray(case["dec_tokens"]), jnp.asarray(case["pos"]))
                got["model"] = dict(logits=np.asarray(logits),
                                    forward_routing=frec,
                                    decode=np.asarray(dec),
                                    decode_routing=drec)
            if "state" in case:
                state = TrainState(**{k: jax.tree.map(jnp.asarray, v)
                                      for k, v in case["state"].items()})
                step = jax.jit(make_train_step(
                    cfg, prof, optimizer="adamw", mode="pot",
                    n_microbatches=2, unroll=True, lr=LR))
                new, loss = step(state, {k: jnp.asarray(v) for k, v in
                                         case["batch"].items()})
                got["train"] = dict(loss=float(loss), state={
                    k: jax.tree.map(np.asarray, getattr(new, k))
                    for k in ("params", "opt", "gv", "step")})
    with open(out, "wb") as f:
        pickle.dump(result, f)


def run_both(tmp_path, parts, archs=ARCHS, cfs=CFS) -> tuple[dict, list]:
    """The reference's subprocess and the port's 8 ranks side by side on
    the same inputs: (the reference's results by case, each rank's)."""
    cases = {(a, cf): case_inputs(a, cf, parts) for a in archs for cf in cfs}
    inputs, ref_out = tmp_path / "inputs.pkl", tmp_path / "ref.pkl"
    with open(inputs, "wb") as f:
        pickle.dump(cases, f)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")]),
        "XLA_FLAGS": f"--xla_force_host_platform_device_count={WORLD}",
        "JAX_PLATFORMS": "cpu"}
    ref = subprocess.Popen(
        [sys.executable, "-c", "import sys, _torch_moe_ep as m; "
         "m.reference_main(sys.argv[1], sys.argv[2])", str(inputs),
         str(ref_out)], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        _torch_dist.spawn(_torch_dist.moe_ep_worker, WORLD, tmp_path / "rdv",
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


def expert_shard(a, name, d, m):
    """Rank (data d, model m)'s shard of a whole expert leaf: experts over
    the model axis, D of w1/w3 and F of w2 over the data axis."""
    el, rows = a.shape[0] // MODEL, a.shape[1] // DATA
    return a[m * el:(m + 1) * el, d * rows:(d + 1) * rows]


def rank_tree(tree, cfg, coord):
    """A whole parameter tree (or AdamW moment) as the rank at ``coord``
    holds it: ``lm.local_params`` on the profile's layout."""
    import _torch_tp
    from repro_torch.models import lm
    return lm.local_params(tree, cfg, _torch_tp.profile(coord))


def check_routing(ref_rec, port_rec, coord):
    """The rank's routing of each call, expert indices and kept mask,
    identical to the reference's block at the same coordinate."""
    assert len(port_rec) == len({c for c, _, _ in ref_rec})
    for call, (eidx, keep) in enumerate(port_rec):
        re, rk = ref_rec[(call, *coord)]
        np.testing.assert_array_equal(eidx.reshape(-1), re.reshape(-1))
        np.testing.assert_array_equal(keep.reshape(-1), rk.reshape(-1))


def same_bits(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()
