"""Shared helpers and checks of the training tests of every layer kind
(``tests/test_torch_train_{kinds, local, moe, moe_residual,
ssm_encoder, dense, dense_patches}.py``, ``tests/test_torch_dp_train_{kinds,
moe_encoder}.py``, ``tests/test_torch_adafactor_kinds.py``): the smoke
batches, the reference's initial states carried across, one step in
each package, and the checks each family's file runs on its
architectures (one file a family or two, so that no file's reference
compiles run long).

**float32.**  Both packages compute in bf16 (``C``) and round at other
places, which hides a fault under rounding.  With ``C`` set to float32
in both packages' model modules (``monkeypatch``; no file changes) the
two compute the same math in float32.  The reference's steps are
jitted afresh, with ``jax.clear_caches()`` around a change of ``C``, so
no trace made under one dtype is reused under the other.
"""

import contextlib
import functools
import os
import pathlib
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist

from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import blocks as ref_blocks
from repro.models import lm as ref_lm
from repro.models import moe as ref_moe
from repro.models import rglru as ref_rglru
from repro.models import ssm as ref_ssm
from repro.runtime.shardings import SMOKE
from repro.train import make_train_step as ref_make_train_step
from repro.train.train_step import TrainState as RefState
from repro.train.train_step import init_state as ref_init_state
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.data.pipeline import DataConfig, batch_at
from repro_torch.models import blocks, lm, moe, rglru, ssm
from repro_torch.train import make_train_step
from repro_torch.tree import leaves

ROOT = pathlib.Path(__file__).resolve().parents[1]
LR = 1e-3
F32_LEAF = 1e-4       # relative L2 per leaf in float32
F32_LOSS = 1e-5
MOE = ("deepseek_moe_16b", "arctic_480b")
# the data step of each MoE model's bf16 batch: one on which both
# packages route every token of both microbatches alike (at step 0
# arctic-smoke routes two tokens apart on a near-tie)
ROUTED_ALIKE_STEP = {"deepseek_moe_16b": 0, "arctic_480b": 1}


@contextlib.contextmanager
def compute_dtype(jdtype, tdtype):
    """``C`` of both packages' model modules set to the given dtypes."""
    mods = [(m, jdtype) for m in (ref_blocks, ref_lm, ref_ssm, ref_rglru,
                                  ref_moe)]
    mods += [(m, tdtype) for m in (blocks, lm, ssm, rglru, moe)]
    with pytest.MonkeyPatch.context() as mp:
        jax.clear_caches()
        for m, d in mods:
            mp.setattr(m, "C", d)
        try:
            yield
        finally:
            jax.clear_caches()


float32 = functools.partial(compute_dtype, jnp.float32, torch.float32)


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.linalg.norm(b)
    return float(np.linalg.norm(a - b) / (scale if scale else 1.0))


def batch_np(arch, step=0, b=4, s=16) -> dict:
    """The data pipeline's batch ``step`` (b x s tokens) with whisper's
    frames and internvl2's patches drawn with numpy from ``step``."""
    cfg = get_smoke_config(arch)
    out = {k: t.numpy() for k, t in batch_at(
        DataConfig(vocab=cfg.vocab, seq_len=s, global_batch=b), step,
        device="cpu").items()}
    rng = np.random.default_rng([11, step])
    if cfg.encoder_layers:
        out["frames"] = rng.normal(size=(b, cfg.n_frames, cfg.d_model)
                                   ).astype(np.float32)
    if cfg.n_patches:
        out["patches"] = rng.normal(size=(b, cfg.n_patches, cfg.d_model)
                                    ).astype(np.float32)
    return out


@functools.lru_cache(maxsize=None)
def ref_initial(arch, optimizer):
    """The reference's initial state (PRNGKey(1)) as numpy trees."""
    s = ref_init_state(ref_lm.init_params(jax.random.PRNGKey(1),
                                          ref_smoke_config(arch)), optimizer)
    return {k: jax.tree.map(np.asarray, getattr(s, k))
            for k in ("params", "opt", "gv", "step")}


def port_initial(arch, optimizer):
    return convert.train_state_from_numpy(ref_initial(arch, optimizer),
                                          get_smoke_config(arch),
                                          device="cpu")


def ref_step(arch, optimizer, batch, mode="pot"):
    """One reference step (pot: 2 microbatches), jitted afresh: (loss,
    the new state as the port's ``TrainState``)."""
    state = RefState(**{k: jax.tree.map(jnp.asarray, v)
                        for k, v in ref_initial(arch, optimizer).items()})
    new, loss = jax.jit(ref_make_train_step(
        ref_smoke_config(arch), SMOKE, optimizer=optimizer, mode=mode,
        n_microbatches=2 if mode == "pot" else 1, remat=False, lr=LR))(
        state, {k: jnp.asarray(v) for k, v in batch.items()})
    tree = {k: jax.tree.map(np.asarray, getattr(new, k))
            for k in ("params", "opt", "gv", "step")}
    return float(loss), convert.train_state_from_numpy(
        tree, get_smoke_config(arch), device="cpu")


def port_step(arch, optimizer, batch, mode="pot", remat=False):
    step = make_train_step(get_smoke_config(arch), optimizer=optimizer,
                           mode=mode, n_microbatches=2 if mode == "pot"
                           else 1, remat=remat, lr=LR)
    new, loss = step(port_initial(arch, optimizer),
                     {k: torch.from_numpy(v) for k, v in batch.items()})
    return float(loss), new


@functools.lru_cache(maxsize=None)
def f32_steps(arch, optimizer, data_step=0):
    """(reference, port) pot steps in float32 on batch ``data_step``."""
    batch = batch_np(arch, data_step)
    with float32():
        return (ref_step(arch, optimizer, batch),
                port_step(arch, optimizer, batch))


def bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def undetermined(got_m, exp_m) -> set[int]:
    """The leaves whose gradients (two lists of numpy arrays, one a
    package) have a column (last axis) more than 1e-3 apart in relative
    L2: a gradient that is a cancellation, such as the router column of
    an expert no token chose (mathematically 0) or qwen1.5's key bias in
    RoPE's slowest dimensions.  Both optimizers normalise the gradient:
    AdamW's ``g / (|g| + eps)`` and Adafactor's factored statistics
    scale such an entry to an O(1) update whose size and sign are
    rounding (Adafactor's clip then couples the whole leaf), so these
    leaves' new parameters are determined by neither package and are
    held through their gradients and statistics."""
    out = set()
    for i, (a, b) in enumerate(zip(got_m, exp_m, strict=True)):
        a = np.asarray(a, np.float64).reshape(-1, np.shape(a)[-1])
        b = np.asarray(b, np.float64).reshape(-1, np.shape(b)[-1])
        diff = np.linalg.norm(a - b, axis=0)
        if (diff > 1e-3 * np.maximum(np.linalg.norm(b, axis=0), 1e-30)).any():
            out.add(i)
    return out


# ------------------------------------------------ the checks, per arch
def undetermined_leaves(arch) -> set[int]:
    """The leaves whose float32 gradient (the AdamW steps' first moment)
    has a cancelled column (``_torch_train.undetermined``)."""
    (_, exp), (_, got) = f32_steps(arch, "adamw")
    return undetermined([t.numpy() for t in leaves(got.opt["m"])],
                        [t.numpy() for t in leaves(exp.opt["m"])])


def check_float32_step(arch, optimizer):
    """One pot step in float32, every leaf of the new state: the
    parameters, AdamW's moments (m is 0.1 g: the gradient) or
    Adafactor's statistics (the tail's and the encoder's too).  The
    parameters of an undetermined leaf (at most one a layer:
    :func:`undetermined_leaves`) are held through their gradients and
    statistics only."""
    (ref_loss, exp), (loss, got) = f32_steps(arch, optimizer)
    np.testing.assert_allclose(loss, ref_loss, rtol=F32_LOSS)
    assert int(got.gv) == int(got.step) == int(got.opt["step"]) == 1
    skip = undetermined_leaves(arch)
    assert len(skip) <= get_smoke_config(arch).n_layers, skip
    worst = {}
    for name in ("params", "opt"):
        pairs = zip(leaves(getattr(got, name)), leaves(getattr(exp, name)),
                    strict=True)
        for i, (a, b) in enumerate(pairs):
            assert a.shape == b.shape and a.dtype == b.dtype
            if not (name == "params" and i in skip):
                worst[(name, i)] = rel(a.numpy(), b.numpy())
    bad = {k: v for k, v in worst.items() if v > F32_LEAF}
    assert not bad, bad


def _record_ref_routing(rec):
    """The reference's ``_route_and_dispatch`` recording (expert index,
    kept) of every call, from inside the jitted step."""
    orig = ref_moe._route_and_dispatch

    def recording(xt, router, e, k, cf):
        out = orig(xt, router, e, k, cf)
        jax.debug.callback(lambda i, kept: rec.append(
            (np.asarray(i).reshape(-1), np.asarray(kept).reshape(-1))),
            out[1], out[3])
        return out
    return recording


def _record_port_routing(rec):
    orig = moe.dispatch_positions

    def recording(flat_e, e, cap, *by_e):
        pos, keep = orig(flat_e, e, cap, *by_e)
        rec.append((flat_e.numpy().copy(), keep.numpy().copy()))
        return pos, keep
    return recording


def check_bf16_gradients(arch, monkeypatch):
    """One AdamW pot step at bf16, each gradient leaf (m / 0.1) within
    max(3e-2, 2 x the port's own bf16-to-float32 distance) of the
    reference's, in relative L2 norm; the losses within rtol 1e-3."""
    step = ROUTED_ALIKE_STEP.get(arch, 0)
    batch = batch_np(arch, step)
    ref_rec, port_rec = [], []
    monkeypatch.setattr(ref_moe, "_route_and_dispatch",
                        _record_ref_routing(ref_rec))
    monkeypatch.setattr(moe, "dispatch_positions",
                        _record_port_routing(port_rec))
    jax.clear_caches()
    ref_loss, exp = ref_step(arch, "adamw", batch)
    jax.effects_barrier()
    loss, got = port_step(arch, "adamw", batch)
    if arch in MOE:
        n = get_smoke_config(arch).n_layers * 2     # layers x microbatches
        assert len(ref_rec) == len(port_rec) == n
        for (re, rk), (pe, pk) in zip(ref_rec, port_rec):
            np.testing.assert_array_equal(pe, re)
            np.testing.assert_array_equal(pk, rk)
    with float32():
        _, f32 = port_step(arch, "adamw", batch)
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-3)
    for i, (a, b, c) in enumerate(zip(leaves(got.opt["m"]),
                                      leaves(exp.opt["m"]),
                                      leaves(f32.opt["m"]), strict=True)):
        own = rel(a.numpy(), c.numpy())
        d = rel(a.numpy(), b.numpy())
        assert d <= max(3e-2, 2 * own), (i, tuple(a.shape), d, own)


def check_deterministic(arch):
    """Two runs of two pot steps (AdamW) bitwise equal, and a run that
    recomputes each layer in the backward pass (``remat``) equal to
    them too; the inputs untouched."""
    cfg = get_smoke_config(arch)
    batches = [{k: torch.from_numpy(v) for k, v in batch_np(arch, i).items()}
               for i in range(2)]
    runs = []
    for remat in (False, False, True):
        step = make_train_step(cfg, mode="pot", n_microbatches=2,
                               remat=remat, lr=LR)
        state = start = port_initial(arch, "adamw")
        before = [t.clone() for t in leaves(start)]
        losses = []
        for b in batches:
            state, loss = step(state, b)
            losses.append(loss)
        assert all(torch.equal(a, b) for a, b in zip(leaves(start), before))
        runs.append([*losses, *leaves(state)])
    for other in runs[1:]:
        assert all(torch.equal(bits(a), bits(b))
                   for a, b in zip(runs[0], other, strict=True))


REF_DP = """
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_smoke_config
from repro.launch.mesh import make_host_mesh
from repro.models import blocks, lm, moe, rglru, ssm
from repro.train.train_step import TrainState, make_pot_dp_step
for m in (blocks, lm, ssm, rglru, moe):
    m.C = jnp.float32
cases, out, lr = sys.argv[1], sys.argv[2], float(sys.argv[3])
with open(cases, "rb") as f:
    cases = pickle.load(f)
result = {}
for (arch, optimizer), (initial, batch) in cases.items():
    state = TrainState(**{k: jax.tree.map(jnp.asarray, v)
                          for k, v in initial.items()})
    step = jax.jit(make_pot_dp_step(get_smoke_config(arch),
                                    make_host_mesh(2), optimizer=optimizer,
                                    n_microbatches=2, lr=lr))
    state, loss = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
    result[(arch, optimizer)] = dict(
        state={k: jax.tree.map(np.asarray, getattr(state, k))
               for k in ("params", "opt", "gv", "step")}, loss=float(loss))
with open(out, "wb") as f:
    pickle.dump(result, f)
"""


def check_dp_two_ranks(arch, tmp_path):
    """One DP step on 2 gloo ranks (global batch 8 of 16 tokens, 2
    microbatches of 2 rows a rank) against the reference's on a 2-device
    mesh, from the reference's initial state, AdamW and Adafactor."""
    cfg = get_smoke_config(arch)
    batch = batch_np(arch, 0, b=8)
    cases = {(arch, opt): (ref_initial(arch, opt), batch)
             for opt in ("adamw", "adafactor")}
    path = tmp_path / "cases.pkl"
    with open(path, "wb") as f:
        pickle.dump(cases, f)
    ref_out = tmp_path / "ref.pkl"
    # the reference's mesh runs beside the port's ranks
    ref = subprocess.Popen(
        [sys.executable, "-c", REF_DP, str(path), str(ref_out), str(LR)],
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    _torch_dist.spawn(_torch_dist.dp_kinds_worker, 2, tmp_path / "rdv",
                      str(path), str(tmp_path / "port"), LR)
    _, err = ref.communicate(timeout=600)
    assert ref.returncode == 0, err[-3000:]
    with open(ref_out, "rb") as f:
        ref_result = pickle.load(f)
    runs = {}
    for opt in ("adamw", "adafactor"):
        exp = convert.train_state_from_numpy(
            ref_result[(arch, opt)]["state"], cfg, device="cpu")
        exp_leaves = [t.numpy() for t in leaves([exp.params, exp.opt])]
        got = [np.load(tmp_path / f"port.{arch}.{opt}.{r}.npz")
               for r in range(2)]
        n = len(exp_leaves)
        for j in range(n):      # both ranks, two runs: bitwise
            for g, r in ((got[0], 1), (got[1], 0), (got[1], 1)):
                np.testing.assert_array_equal(
                    got[0][f"leaf_0_{j}"].view(np.int32),
                    g[f"leaf_{r}_{j}"].view(np.int32))
        assert got[0]["loss_0"] == got[0]["loss_1"] == got[1]["loss_0"]
        assert got[0]["counters_0"].tolist() == [1, 1] == [int(exp.gv),
                                                          int(exp.step)]
        np.testing.assert_allclose(float(got[0]["loss_0"]),
                                   ref_result[(arch, opt)]["loss"],
                                   rtol=F32_LOSS)
        runs[opt] = ([got[0][f"leaf_0_{j}"] for j in range(n)], exp_leaves)
    n_params = len(leaves(exp.params))
    got_m, exp_m = (x[n_params:2 * n_params] for x in runs["adamw"])
    skip = undetermined(got_m, exp_m)
    assert len(skip) <= cfg.n_layers, skip
    for opt, (got, exp_leaves) in runs.items():
        bad = {j: rel(a, b) for j, (a, b) in enumerate(zip(got, exp_leaves))
               if j not in skip and rel(a, b) > F32_LEAF}
        assert not bad, (opt, bad)
