"""Parity of the port's training path with the JAX reference at smoke
sizes: the training attention (``repro.models.blocks.attn_apply``), the
forward pass (``repro.models.lm.forward``), the loss and one train step
(``repro.train.make_train_step``) in both modes, the data pipeline, the
trainer checkpoints, deterministic restart and the launcher.

Weights come from the reference's own ``init_params`` and cross as
numpy (``convert``); inputs are numpy draws.  Both sides keep float32
master weights and compute in bf16 with float32 accumulation, rounding
at different places, so the model math holds at the reference tests'
tolerance, rtol = atol = 3e-2 (``tests/test_arch_smoke.py``); what is
integer or pure copying (the data, the counters, the checkpoints, the
port against itself) is held bitwise.
"""

import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke_config as ref_smoke_config
from repro.data import pipeline as ref_pipeline
from repro.models import blocks as ref_blocks
from repro.models import lm as ref_lm
from repro.runtime.shardings import SMOKE
from repro.train import make_train_step as ref_make_train_step
from repro.train.train_step import init_state as ref_init_state
from repro.train.train_step import loss_fn as ref_loss_fn
from repro_torch import convert
from repro_torch.ckpt import checkpoint as ck
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data.pipeline import DataConfig, batch_at, stream
from repro_torch.models import blocks, lm
from repro_torch.train import init_state, loss_fn, make_train_step
from repro_torch.tree import leaves, unflatten

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = dict(rtol=3e-2, atol=3e-2)
ARCHS = ["stablelm-12b", "qwen15_32b", "starcoder2-15b", "internvl2-26b"]


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _params(arch, seed=0):
    """The reference's parameters and the port's float32 copy of them."""
    cfg = ref_smoke_config(arch)
    ref = ref_lm.init_params(jax.random.PRNGKey(seed), cfg)
    port = convert.lm_params_from_numpy(jax.tree.map(np.asarray, ref),
                                        get_smoke_config(arch), device="cpu",
                                        dtype=torch.float32)
    return cfg, ref, port


def _batch(cfg, rng, b=2, s=16):
    """Tokens and labels (the last of each row masked) as numpy, plus
    patches for the VLM."""
    tokens = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    labels = np.concatenate([tokens[:, 1:], np.full((b, 1), -1, np.int32)],
                            axis=1)
    batch = {"tokens": tokens, "labels": labels}
    if cfg.n_patches:
        batch["patches"] = rng.normal(
            size=(b, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return batch


@pytest.mark.parametrize("arch,chunk", [
    ("stablelm-12b", 0),      # GQA 4 heads over 2 KV heads
    ("stablelm-12b", 4),      # queries in chunks of 4
    ("qwen15_32b", 0),        # QKV bias (made non-zero here)
    ("starcoder2-15b", 8),    # the GELU arch's widths, in chunks of 8
])
def test_attn_apply_matches_reference(arch, chunk):
    cfg, ref, port = _params(arch)
    rng = np.random.default_rng(len(arch) + chunk)
    jp = jax.tree.map(lambda a: a[0], ref["layers"]["0"]["attn"])
    tp = port["layers"][0]["attn"]
    if cfg.qkv_bias:
        for name in ("bq", "bk", "bv"):
            bias = rng.normal(size=tp[name].shape).astype(np.float32)
            jp[name], tp[name] = jnp.asarray(bias), torch.from_numpy(bias)
    x = rng.normal(size=(2, 16, cfg.d_model)).astype(np.float32)
    jout = ref_blocks.attn_apply(
        jp, jnp.asarray(x, jnp.bfloat16), cfg, SMOKE, chunk=chunk)
    tout = blocks.attn_apply(
        tp, torch.from_numpy(x).bfloat16(), get_smoke_config(arch),
        chunk=chunk)
    assert tout.dtype == torch.bfloat16 and tout.shape == jout.shape
    np.testing.assert_allclose(_f32(tout), _f32(jout), **TOL)


def test_attend_full_chunks_need_a_multiple():
    q = torch.zeros((1, 6, 2, 4), dtype=torch.bfloat16)
    pos = torch.arange(6)[None]
    with pytest.raises(ValueError, match="multiple of chunk"):
        blocks.attend_full(q, q, q, pos, pos, chunk=4)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    """Logits of the whole model; internvl2 with its stub patches."""
    cfg, ref, port = _params(arch, seed=1)
    batch = _batch(cfg, np.random.default_rng(2))
    patches = batch.get("patches")
    jlog = ref_lm.forward(
        ref, jnp.asarray(batch["tokens"]), cfg, SMOKE,
        prefix_embeds=None if patches is None else jnp.asarray(patches))
    tlog = lm.forward(
        port, torch.from_numpy(batch["tokens"]), get_smoke_config(arch),
        prefix_embeds=None if patches is None else torch.from_numpy(patches))
    assert tlog.shape == (2, 16 + cfg.n_patches, cfg.padded_vocab)
    assert tlog.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(tlog), _f32(jlog), **TOL)


@pytest.mark.parametrize("arch", ["stablelm-12b", "internvl2-26b"])
def test_loss_matches_reference(arch):
    """The masked next-token loss.  bf16 rounding of single logits
    averages out over the batch: rtol 1e-3 (1e-5 is typical)."""
    cfg, ref, port = _params(arch, seed=3)
    batch = _batch(cfg, np.random.default_rng(4))
    batch["labels"][0, :5] = -1
    jloss = ref_loss_fn(ref, {k: jnp.asarray(v) for k, v in batch.items()},
                        cfg, SMOKE, remat=False)
    tloss = loss_fn(port, {k: torch.from_numpy(v) for k, v in batch.items()},
                    get_smoke_config(arch), remat=False)
    assert tloss.shape == () and tloss.dtype == torch.float32
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-3)


@pytest.mark.parametrize("mode,n_mb", [("pot", 2), ("baseline", 1)])
def test_train_step_matches_reference(mode, n_mb):
    """One step from the reference's initial state, carried over with
    ``convert.train_state_from_numpy``, against the reference's jitted
    step.  The counters are exact.  The gradient is read off m
    (m' = 0.1 g from m = 0): each leaf agrees within 3e-2 in relative L2
    norm (the model tests' tolerance over the leaf; bf16 rounds at other
    places in every product of the backward pass), and v' = 0.001 g²,
    whose relative error is twice g's, within 6e-2.  At step 1 the update
    is lr·(g/|g| + wd·p): p' agrees to rounding wherever |g| is clear of
    that noise (|m| above 3e-2 of the leaf's largest), and elsewhere the
    sign of a near-zero g may differ, which moves p' by at most
    2·lr·(1 + wd·|p|)."""
    lr, wd = 1e-3, 0.01
    rcfg = ref_smoke_config("stablelm-12b")
    cfg = get_smoke_config("stablelm-12b")
    ref_state = ref_init_state(ref_lm.init_params(jax.random.PRNGKey(1),
                                                  rcfg))
    state = convert.train_state_from_numpy(
        jax.tree.map(np.asarray, ref_state), cfg, device="cpu")
    dcfg = dict(vocab=rcfg.vocab, seq_len=16, global_batch=4)
    ref_step = jax.jit(ref_make_train_step(
        rcfg, SMOKE, mode=mode, n_microbatches=n_mb, remat=False, lr=lr,
        wd=wd))
    ref_new, ref_loss = ref_step(
        ref_state, ref_pipeline.batch_at(ref_pipeline.DataConfig(**dcfg), 0))
    step = make_train_step(cfg, mode=mode, n_microbatches=n_mb, remat=False,
                           lr=lr, wd=wd)
    new, loss = step(state, batch_at(DataConfig(**dcfg), 0, device="cpu"))
    exp = convert.train_state_from_numpy(jax.tree.map(np.asarray, ref_new),
                                         cfg, device="cpu")

    assert int(new.gv) == int(exp.gv) == (1 if mode == "pot" else 0)
    assert int(new.step) == int(new.opt["step"]) == int(exp.step) == 1
    assert new.gv.dtype == new.step.dtype == torch.int32
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-3)
    rel = lambda a, b: float((a - b).norm() / b.norm())
    for p, m, v, ep, em, ev in zip(
            leaves(new.params), leaves(new.opt["m"]), leaves(new.opt["v"]),
            leaves(exp.params), leaves(exp.opt["m"]), leaves(exp.opt["v"])):
        assert rel(m, em) <= 3e-2 and rel(v, ev) <= 6e-2
        clear = em.abs() > 3e-2 * em.abs().max()
        assert clear.any()
        np.testing.assert_allclose(p[clear].numpy(), ep[clear].numpy(),
                                   rtol=1e-5, atol=1e-6)
        bound = 2 * lr * (1 + wd * float(ep.abs().max())) + 1e-6
        assert float((p - ep).abs().max()) <= bound


def test_full_width_layer_trains_as_reference():
    """One layer at stablelm-12b's full widths (d_model 5120, 32 query
    heads over 8 KV heads of 160, SwiGLU 13824; the vocabulary cut to
    512), trained 3 pot steps with the chip run's optimizer settings
    (lr 3e-4, wd 0.01, 2 microbatches) from the reference's initial
    weights: the per-step losses agree within rtol 1e-2.  Step 1 holds
    to 1e-3 as in the loss test; each later step carries the parameters
    that a bf16-noisy near-zero gradient moved the other way (by lr), so
    the losses drift apart a little (3.2e-3 at step 3 when written).
    At this width Adam's first steps overshoot and the loss rises in the
    reference as in the port, which the test pins too.  About 8 GB of
    host memory on each side, one side at a time."""
    kw = dict(mode="pot", n_microbatches=2, remat=False, lr=3e-4, wd=0.01)
    rcfg = dataclasses.replace(ref_get_config("stablelm-12b"), n_layers=1,
                               vocab=512)
    cfg = dataclasses.replace(get_config("stablelm-12b"), n_layers=1,
                              vocab=512)
    dcfg = dict(vocab=512, seq_len=16, global_batch=4)
    ref_params = ref_lm.init_params(jax.random.PRNGKey(0), rcfg)
    params = convert.lm_params_from_numpy(
        jax.tree.map(np.asarray, ref_params), cfg, device="cpu",
        dtype=torch.float32)
    ref_state = ref_init_state(ref_params)
    del ref_params
    ref_step = jax.jit(ref_make_train_step(rcfg, SMOKE, **kw),
                       donate_argnums=0)
    ref_losses = []
    for i in range(3):
        ref_state, loss = ref_step(
            ref_state,
            ref_pipeline.batch_at(ref_pipeline.DataConfig(**dcfg), i))
        ref_losses.append(float(loss))
    del ref_state
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        state, losses = init_state(params), []
        del params
        step = make_train_step(cfg, **kw)
        for i in range(3):
            state, loss = step(state,
                               batch_at(DataConfig(**dcfg), i, device="cpu"))
            losses.append(float(loss))
    finally:
        torch.set_num_threads(threads)
    assert int(state.gv) == int(state.step) == 3
    np.testing.assert_allclose(losses[0], ref_losses[0], rtol=1e-3)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-2)
    assert ref_losses[1] > ref_losses[0] and losses[1] > losses[0]


def test_remat_changes_no_bit_and_chunk_no_logit():
    """Recomputing each layer in the backward pass changes the schedule,
    not the arithmetic: loss and every gradient bitwise equal.  Query
    chunks leave the logits and the loss bitwise equal too; the backward
    pass then sums the K/V gradients chunk by chunk in bf16, so the
    gradients agree within 3e-2 in relative L2 norm."""
    cfg = get_smoke_config("stablelm-12b")
    params = lm.init_params(torch.Generator().manual_seed(0), cfg,
                            dtype=torch.float32)
    batch = {k: torch.from_numpy(v) for k, v in
             _batch(cfg, np.random.default_rng(5)).items()}
    runs = []
    for remat, chunk in ((False, 0), (True, 0), (True, 8)):
        ps = [p.clone().requires_grad_(True) for p in leaves(params)]
        tree = unflatten(params, ps)
        value = loss_fn(tree, batch, cfg, remat=remat, chunk=chunk)
        logits = lm.forward(tree, batch["tokens"], cfg, chunk=chunk)
        runs.append(([value, logits], torch.autograd.grad(value, ps)))
    (base, grads), (remat, remat_grads), (chunked, chunk_grads) = runs
    assert all(torch.equal(a, b) for a, b in zip(base + list(grads),
                                                 remat + list(remat_grads)))
    assert all(torch.equal(a, b) for a, b in zip(base, chunked))
    for a, b in zip(chunk_grads, grads):
        assert float((a - b).norm() / b.norm()) <= 3e-2


def test_pot_step_is_functional_and_deterministic():
    """Two runs of a pot step from one state agree bitwise; the state
    given is left as it was; gv and step advance by one."""
    cfg = get_smoke_config("stablelm-12b")
    state = init_state(lm.init_params(torch.Generator().manual_seed(1), cfg,
                                      dtype=torch.float32))
    before = [t.clone() for t in leaves(state)]
    step = make_train_step(cfg, mode="pot", n_microbatches=2)
    batch = batch_at(DataConfig(vocab=cfg.vocab, seq_len=16,
                                global_batch=4), 3, device="cpu")
    (a, la), (b, lb) = step(state, batch), step(state, batch)
    assert all(torch.equal(x, y) for x, y in zip(leaves(state), before))
    assert torch.equal(la, lb) and torch.isfinite(la)
    assert all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))
    assert int(a.gv) == int(a.step) == 1
    moved = [not torch.equal(x, y) for x, y in zip(leaves(a.params),
                                                   leaves(state.params))]
    assert all(moved)


@pytest.mark.parametrize("dcfg", [
    dict(vocab=1000, seq_len=32, global_batch=8),
    dict(vocab=100352, seq_len=128, global_batch=8, seed=3),
    dict(vocab=500, seq_len=16, global_batch=8, n_hosts=2, host_id=1),
])
def test_batch_at_matches_reference_bitwise(dcfg):
    for step in (0, 5):
        exp = ref_pipeline.batch_at(ref_pipeline.DataConfig(**dcfg), step)
        got = batch_at(DataConfig(**dcfg), step, device="cpu")
        assert set(got) == set(exp)
        for k in exp:
            assert got[k].dtype == torch.int32
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(exp[k]))
    it = stream(DataConfig(**dcfg), start_step=4, device="cpu")
    s, b = next(it)
    assert s == 4 and torch.equal(b["tokens"], batch_at(
        DataConfig(**dcfg), 4, device="cpu")["tokens"])


def _state(seed=0):
    cfg = get_smoke_config("stablelm-12b")
    return init_state(lm.init_params(torch.Generator().manual_seed(seed),
                                     cfg, dtype=torch.float32))


def test_checkpoint_round_trip_with_extra(tmp_path):
    state = dataclasses.replace(_state(),
                                gv=torch.tensor(9, dtype=torch.int32))
    path = ck.save(str(tmp_path), 7, state, extra={"data_step": 7})
    assert os.path.basename(path) == "step_7"
    assert sorted(os.listdir(path)) == ["manifest.json", "shard_0.npz"]
    restored, extra = ck.restore(str(tmp_path), 7, _state(seed=1))
    assert extra == {"data_step": 7}
    assert isinstance(restored, type(state))
    for a, b in zip(leaves(state), leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with pytest.raises(ValueError, match="leaves"):
        ck.restore(str(tmp_path), 7, {"w": torch.zeros(3)})


def test_checkpoint_tmp_dirs_never_count_and_prune(tmp_path, monkeypatch):
    d = str(tmp_path)
    assert ck.latest_step(d) is None
    small = {"w": torch.ones(2), "step": torch.tensor(1, dtype=torch.int32)}
    for s in (1, 2, 3, 4, 5):
        ck.save(d, s, small)
    os.makedirs(os.path.join(d, "step_9.tmp_0"))     # a torn save
    assert ck.latest_step(d) == 5
    ck.prune(d, keep=2)
    assert sorted(os.listdir(d)) == ["step_4", "step_5", "step_9.tmp_0"]

    # a crash in the middle of a save leaves the previous checkpoint
    def crash(*a, **k):
        raise OSError("disk gone")
    monkeypatch.setattr(ck.np, "savez", crash)
    with pytest.raises(OSError):
        ck.save(d, 6, small)
    assert ck.latest_step(d) == 5
    assert os.path.isdir(os.path.join(d, "step_6.tmp_0"))


def test_restart_reproduces_run_bitwise(tmp_path):
    """4 steps straight against 2 steps, a checkpoint, a restore into a
    fresh state and 2 more steps: every leaf bitwise equal, the loss
    stream too."""
    cfg = get_smoke_config("stablelm-12b")
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=4)
    step = make_train_step(cfg, mode="pot", n_microbatches=2, remat=False)
    straight, losses = _state(seed=2), []
    for i in range(4):
        straight, loss = step(straight, batch_at(dcfg, i, device="cpu"))
        losses.append(loss)
    s = _state(seed=2)
    for i in range(2):
        s, _ = step(s, batch_at(dcfg, i, device="cpu"))
    ck.save(str(tmp_path), 2, s, extra={"data_step": 2})
    s, extra = ck.restore(str(tmp_path), 2, _state(seed=5))
    again = []
    for i in range(extra["data_step"], 4):
        s, loss = step(s, batch_at(dcfg, i, device="cpu"))
        again.append(loss)
    assert int(s.gv) == int(straight.gv) == 4
    assert all(torch.equal(a, b) for a, b in zip(leaves(straight),
                                                 leaves(s)))
    assert torch.equal(torch.stack(losses[2:]), torch.stack(again))


def test_unported_options_raise():
    """Adafactor is ported (tests/test_torch_dp_train.py holds it to the
    reference); an unknown optimizer or mode raises."""
    cfg = get_smoke_config("stablelm-12b")
    make_train_step(cfg, optimizer="adafactor")
    assert set(init_state({"w": torch.zeros(2)}, optimizer="adafactor")
               .opt) == {"stats", "step"}
    with pytest.raises(ValueError, match="optimizer"):
        make_train_step(cfg, optimizer="sgd")
    with pytest.raises(ValueError, match="optimizer"):
        init_state({"w": torch.zeros(2)}, optimizer="sgd")
    with pytest.raises(ValueError, match="mode"):
        make_train_step(cfg, mode="fast")


def test_launcher_trains_and_resumes_on_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "stablelm-12b", "--smoke", "--device", "cpu", "--seq", "16",
           "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    first = subprocess.run(cmd + ["--steps", "2"], capture_output=True,
                           text=True, timeout=300, env=env, cwd=ROOT)
    assert first.returncode == 0, first.stderr
    assert "arch=stablelm-smoke" in first.stdout
    assert "step    1  loss" in first.stdout and "done" in first.stdout
    assert ck.latest_step(str(tmp_path)) == 2
    second = subprocess.run(cmd + ["--steps", "3", "--resume"],
                            capture_output=True, text=True, timeout=300,
                            env=env, cwd=ROOT)
    assert second.returncode == 0, second.stderr
    assert "resumed at step 2 (gv=2)" in second.stdout
    assert "step    3  loss" in second.stdout
