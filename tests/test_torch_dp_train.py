"""The port's deterministic data-parallel training against the JAX
reference: ``make_pot_dp_step`` over gloo ranks against the reference's
``make_pot_dp_step`` on a host-device mesh, Adafactor through
``init_state`` / ``make_train_step``, the trainer checkpoint of an
Adafactor state, and the launcher ``python -m
repro_torch.launch.train_lm`` on the CPU.

Weights come from the reference's ``init_params`` and cross as numpy.
The model math is held at the reference tests' tolerance, rtol = atol =
3e-2 (bf16 rounds at other places in both packages, as in
``tests/test_torch_train.py``); what the ordered commits promise — two
runs of one step, the one-rank ring against the plain Pot step, a
restart — is held bitwise.
"""

import os
import pathlib
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import _torch_dist

from repro.configs import get_smoke_config as ref_smoke_config
from repro.data import pipeline as ref_pipeline
from repro.models import lm as ref_lm
from repro.runtime.shardings import SMOKE
from repro.train import make_train_step as ref_make_train_step
from repro.train.train_step import init_state as ref_init_state
from repro_torch import convert
from repro_torch.ckpt import checkpoint as ck
from repro_torch.configs import get_smoke_config
from repro_torch.data.pipeline import DataConfig, batch_at
from repro_torch.models import lm
from repro_torch.train import init_state, make_pot_dp_step, make_train_step
from repro_torch.tree import leaves

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = dict(rtol=3e-2, atol=3e-2)
ARCH = "stablelm-12b"
LR = 1e-3
DP_STEPS = 2

REF_DP = """
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_smoke_config
from repro.data.pipeline import DataConfig, batch_at
from repro.launch.mesh import make_host_mesh
from repro.train.train_step import TrainState, make_pot_dp_step
out, steps, lr = sys.argv[1], int(sys.argv[2]), float(sys.argv[3])
cfg = get_smoke_config("stablelm-12b")
dcfg = DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=8)
result = {}
for optimizer, path in zip(("adamw", "adafactor"), sys.argv[4:]):
    with open(path, "rb") as f:
        s = pickle.load(f)
    state = TrainState(**{k: jax.tree.map(jnp.asarray, v)
                          for k, v in s.items()})
    step = jax.jit(make_pot_dp_step(cfg, make_host_mesh(2),
                                    optimizer=optimizer, n_microbatches=2,
                                    lr=lr))
    losses = []
    for i in range(steps):
        state, loss = step(state, batch_at(dcfg, i))
        losses.append(float(loss))
    result[optimizer] = dict(
        state={k: jax.tree.map(np.asarray, getattr(state, k))
               for k in ("params", "opt", "gv", "step")}, losses=losses)
with open(out, "wb") as f:
    pickle.dump(result, f)
"""


def _ref_state(optimizer, seed=0):
    """The reference's initial state as a dict of numpy trees."""
    s = ref_init_state(ref_lm.init_params(jax.random.PRNGKey(seed),
                                          ref_smoke_config(ARCH)), optimizer)
    return {k: jax.tree.map(np.asarray, getattr(s, k))
            for k in ("params", "opt", "gv", "step")}


def test_dp_step_matches_reference_on_two_ranks(tmp_path):
    """Two gloo ranks against the reference's step on a 2-device mesh,
    2 steps from the reference's initial state (global batch 8 of 16
    tokens, 2 microbatches a rank), AdamW and Adafactor: the losses and
    every parameter within rtol = atol = 3e-2, AdamW's first moment (the
    gradients' running sum) within 3e-2 in relative L2 norm per leaf,
    the counters exact; and each run bitwise equal to a second run."""
    cfg = get_smoke_config(ARCH)
    paths = {}
    for opt in ("adamw", "adafactor"):
        paths[opt] = tmp_path / f"init_{opt}.pkl"
        with open(paths[opt], "wb") as f:
            pickle.dump(_ref_state(opt), f)
    ref_out = tmp_path / "ref.pkl"
    # the reference's mesh runs beside the port's ranks
    ref = subprocess.Popen(
        [sys.executable, "-c", REF_DP, str(ref_out), str(DP_STEPS),
         str(LR), str(paths["adamw"]), str(paths["adafactor"])],
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    _torch_dist.spawn(_torch_dist.dp_worker, 2, tmp_path / "rdv",
                      {k: str(v) for k, v in paths.items()},
                      str(tmp_path / "port"), DP_STEPS, LR)
    _, err = ref.communicate(timeout=600)
    assert ref.returncode == 0, err[-3000:]
    with open(ref_out, "rb") as f:
        ref_result = pickle.load(f)
    rel = lambda a, b: float(np.linalg.norm(a - b) / np.linalg.norm(b))
    for opt in ("adamw", "adafactor"):
        exp = convert.train_state_from_numpy(ref_result[opt]["state"], cfg,
                                             device="cpu")
        exp_leaves = leaves([exp.params, exp.opt])
        with np.load(tmp_path / f"port.{opt}.npz") as got:
            n = len(exp_leaves)
            for j in range(n):      # two runs, bitwise
                np.testing.assert_array_equal(
                    got[f"leaf_0_{j}"].view(np.int32),
                    got[f"leaf_1_{j}"].view(np.int32))
            np.testing.assert_array_equal(got["losses_0"], got["losses_1"])
            assert got["counters_0"].tolist() == [DP_STEPS, DP_STEPS] == \
                [int(exp.gv), int(exp.step)]
            np.testing.assert_allclose(got["losses_0"],
                                       ref_result[opt]["losses"], **TOL)
            n_params = len(leaves(exp.params))
            for j in range(n_params):
                np.testing.assert_allclose(got[f"leaf_0_{j}"],
                                           exp_leaves[j].numpy(), **TOL)
            if opt == "adamw":
                m = leaves(exp.opt["m"])
                for j, e in enumerate(m):
                    assert rel(got[f"leaf_0_{n_params + j}"],
                               e.numpy()) <= 3e-2


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_one_rank_dp_step_is_the_pot_step_bitwise(optimizer):
    """With no process group the ring is one rank (the reference's
    ``n == 1``), so a DP step computes the pot step's operations: two
    steps of each bitwise equal, counters and losses too."""
    cfg = get_smoke_config(ARCH)
    params = lm.init_params(torch.Generator().manual_seed(3), cfg,
                            dtype=torch.float32)
    kw = dict(optimizer=optimizer, n_microbatches=2, lr=LR, remat=False)
    dp = make_pot_dp_step(cfg, **kw)
    pot = make_train_step(cfg, mode="pot", **kw)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=4)
    a = b = init_state(params, optimizer)
    for i in range(2):
        a, la = dp(a, batch_at(dcfg, i, device="cpu"))
        b, lb = pot(b, batch_at(dcfg, i, device="cpu"))
        assert torch.equal(la, lb)
    bits = lambda t: t.view(torch.int32) if t.is_floating_point() else t
    assert all(torch.equal(bits(x), bits(y))
               for x, y in zip(leaves(a), leaves(b), strict=True))
    assert int(a.gv) == int(a.step) == 2


def test_dp_step_rejects_a_batch_that_does_not_split(monkeypatch):
    from repro_torch.train import train_step
    monkeypatch.setattr(train_step, "ring_position", lambda group: (3, 0))
    cfg = get_smoke_config(ARCH)
    step = make_pot_dp_step(cfg)
    state = init_state(lm.init_params(torch.Generator().manual_seed(0), cfg,
                                      dtype=torch.float32))
    with pytest.raises(ValueError, match="does not split over 3 ranks"):
        step(state, batch_at(DataConfig(vocab=cfg.vocab, seq_len=8,
                                        global_batch=4), 0, device="cpu"))


def test_adafactor_train_step_matches_reference():
    """``make_train_step(optimizer="adafactor")`` (lr only, as in the
    reference) one pot step from the reference's initial Adafactor state:
    the loss, every parameter and every statistic within the model
    tolerance, the counters exact."""
    rcfg, cfg = ref_smoke_config(ARCH), get_smoke_config(ARCH)
    ref_state = ref_init_state(ref_lm.init_params(jax.random.PRNGKey(1),
                                                  rcfg), "adafactor")
    state = convert.train_state_from_numpy(
        jax.tree.map(np.asarray, ref_state), cfg, device="cpu")
    dcfg = dict(vocab=rcfg.vocab, seq_len=16, global_batch=4)
    ref_new, ref_loss = jax.jit(ref_make_train_step(
        rcfg, SMOKE, optimizer="adafactor", mode="pot", n_microbatches=2,
        remat=False, lr=LR))(
        ref_state, ref_pipeline.batch_at(ref_pipeline.DataConfig(**dcfg), 0))
    new, loss = make_train_step(cfg, optimizer="adafactor", mode="pot",
                                n_microbatches=2, remat=False, lr=LR)(
        state, batch_at(DataConfig(**dcfg), 0, device="cpu"))
    exp = convert.train_state_from_numpy(jax.tree.map(np.asarray, ref_new),
                                         cfg, device="cpu")
    assert int(new.gv) == int(new.step) == int(new.opt["step"]) == 1
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-3)
    for a, b in zip(leaves([new.params, new.opt]),
                    leaves([exp.params, exp.opt]), strict=True):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


def test_adafactor_restart_reproduces_run_bitwise(tmp_path):
    """4 Adafactor steps straight against 2, a checkpoint, a restore into
    a fresh state and 2 more: every leaf (parameters, stacked statistics,
    step counters) bitwise equal."""
    cfg = get_smoke_config(ARCH)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=4)
    step = make_train_step(cfg, optimizer="adafactor", mode="pot",
                           n_microbatches=2, remat=False)
    fresh = lambda seed: init_state(lm.init_params(
        torch.Generator().manual_seed(seed), cfg, dtype=torch.float32),
        "adafactor")
    straight = fresh(2)
    for i in range(4):
        straight, _ = step(straight, batch_at(dcfg, i, device="cpu"))
    s = fresh(2)
    for i in range(2):
        s, _ = step(s, batch_at(dcfg, i, device="cpu"))
    ck.save(str(tmp_path), 2, s, extra={"data_step": 2})
    s, extra = ck.restore(str(tmp_path), 2, fresh(5))
    for i in range(extra["data_step"], 4):
        s, _ = step(s, batch_at(dcfg, i, device="cpu"))
    assert int(s.opt["step"]) == int(s.gv) == 4
    assert all(torch.equal(a, b) for a, b in zip(leaves(straight),
                                                 leaves(s), strict=True))


def test_train_lm_launcher_on_two_cpu_ranks(tmp_path):
    """``--world 2 --device cpu``, the 25m model cut to 2 layers: 3 steps
    with a checkpoint every 2 and the live re-run of step 1 (bitwise),
    then a resume from the checkpoint to step 4."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.train_lm", "--world",
           "2", "--device", "cpu", "--layers", "2", "--batch", "4", "--seq",
           "16", "--ckpt-every", "2", "--ckpt-dir", str(tmp_path)]
    first = subprocess.run(cmd + ["--steps", "3"], capture_output=True,
                           text=True, timeout=300, env=env, cwd=ROOT)
    assert first.returncode == 0, first.stderr[-3000:]
    assert "model=pot-lm-25m layers=2" in first.stdout
    assert "world=2 device=cpu" in first.stdout
    assert "step    1  loss" in first.stdout
    assert "replayed step 1 bitwise-identical: True" in first.stdout
    assert ck.latest_step(str(tmp_path)) == 2
    second = subprocess.run(cmd + ["--steps", "4", "--resume"],
                            capture_output=True, text=True, timeout=300,
                            env=env, cwd=ROOT)
    assert second.returncode == 0, second.stderr[-3000:]
    assert "resumed from step 2 (gv=2)" in second.stdout
    assert "step    3  loss" in second.stdout
    assert "replayed" not in second.stdout
    assert ck.latest_step(str(tmp_path)) == 4
