"""Parity of the port's optimizers and gradient commits with the JAX
reference (``repro.optim``, ``repro.runtime.straggler``): Adafactor,
top-k compression with error feedback, the pairwise tree, the fixed-ring
ordered reduction across gloo ranks, and the straggler model.

Inputs are numpy draws from a seed.  Compression, the tree, the ring and
the straggler model are exact (copies, selects, the same float additions
in the same order) and held bitwise; the ring against the reference's
``shard_map`` run in a subprocess with 4 host devices.

Adafactor is held within rtol 1e-5 and atol 1e-7 per update: XLA and
torch compute ``step^-0.8``, the means and ``rsqrt`` with their own last
bits.  The new parameter ``p - lr u - lr wd p`` is held to 1e-5 of the
larger of its inputs' magnitudes: where lr·u nearly cancels p, a last-bit
difference in u is a large share of the small difference.
"""

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

import _torch_dist

from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import lm as ref_lm
from repro.optim import adafactor as ref_adafactor
from repro.optim import compress as ref_compress
from repro.optim import ordered_reduce as ref_reduce
from repro.runtime import straggler as ref_straggler
from repro.train.train_step import init_state as ref_init_state
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.optim import (adafactor, adafactor_init, adafactor_update,
                               error_feedback_init, ordered_ring_reduce,
                               ordered_ring_sum, ordered_tree_sum,
                               topk_compress)
from repro_torch.optim.ordered_reduce import ring_position
from repro_torch.runtime import straggler
from repro_torch.tree import leaves

ROOT = pathlib.Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-5, 1e-7


def _assert_update_close(got, exp, before=None, msg=""):
    """|got - exp| <= ATOL + RTOL max(|exp|, |before|) (module doc)."""
    got, exp = got.numpy(), np.asarray(exp)
    scale = np.abs(exp) if before is None else np.maximum(
        np.abs(exp), np.abs(np.asarray(before)))
    excess = np.abs(got - exp) - (ATOL + RTOL * scale)
    assert excess.max() <= 0, f"{msg}: {excess.max():.3e} over the bound"


# ------------------------------------------------------------ Adafactor
def _adafactor_runs(steps, seed=0):
    """``steps`` Adafactor updates of stablelm-smoke (2 layers, so each
    layer leaf is the reference's (2, ...) stack) from the reference's
    initial state, the gradients numpy draws with sparse spikes, in both
    packages: yields (port state, the reference's state carried across,
    the parameters before) after each step."""
    rcfg = ref_smoke_config("stablelm-12b")
    cfg = get_smoke_config("stablelm-12b")
    ref = ref_init_state(ref_lm.init_params(jax.random.PRNGKey(seed), rcfg),
                         "adafactor")
    port = convert.train_state_from_numpy(jax.tree.map(np.asarray, ref),
                                          cfg, device="cpu")
    rng = np.random.default_rng(seed)
    params, opt = port.params, port.opt
    for _ in range(steps):
        g = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * np.where(
            rng.random(a.shape) < 0.01, 30.0, 1.0)).astype(np.float32),
            ref.params)
        rp, ro = ref_adafactor.adafactor_update(
            ref.params, jax.tree.map(jnp.asarray, g), ref.opt, lr=1e-2)
        before = params
        params, opt = adafactor_update(
            params, convert.lm_params_from_numpy(g, cfg, device="cpu",
                                                 dtype=torch.float32),
            opt, lr=1e-2)
        ref = ref.__class__(params=rp, opt=ro, gv=ref.gv, step=ref.step)
        exp = convert.train_state_from_numpy(jax.tree.map(np.asarray, ref),
                                             cfg, device="cpu")
        yield params, opt, exp, before


def test_adafactor_matches_reference_on_the_stacked_model():
    """Three updates of the whole smoke model, each held to the
    reference's: the stacked norm scales ``ln1`` / ``ln2`` (2, 64) are
    factored across the two layers (``vr`` (2,), ``vc`` (64,)), the final
    norm (64,) is not; every layer leaf is clipped over its stack."""
    for i, (params, opt, exp, before) in enumerate(_adafactor_runs(3)):
        assert int(opt["step"]) == int(exp.opt["step"]) == i + 1
        stats = opt["stats"]
        assert stats["layers"]["0"]["ln1"]["vr"].shape == (2,)
        assert stats["layers"]["0"]["ln1"]["vc"].shape == (64,)
        assert stats["final_norm"]["v"].shape == (64,)
        for a, b, p in zip(leaves(params), leaves(exp.params),
                           leaves(before)):
            _assert_update_close(a, b, p, f"step {i + 1} parameter")
        for a, b in zip(leaves(stats), leaves(exp.opt["stats"])):
            _assert_update_close(a, b, msg=f"step {i + 1} statistic")


def test_adafactor_clip_domain_is_held(monkeypatch):
    """The port clipping each layer of the stacked (2, 64, 64) leaves on
    its own (the group-by-group branch taken below its threshold) misses
    the reference: the clip domain is observable at this size, so the
    parity above holds it."""
    monkeypatch.setattr(adafactor, "_GROUPED_ABOVE", 0)
    params, _, exp, before = next(_adafactor_runs(1))
    with pytest.raises(AssertionError, match="over the bound"):
        for a, b, p in zip(leaves(params), leaves(exp.params),
                           leaves(before)):
            _assert_update_close(a, b, p)


def test_adafactor_above_the_group_threshold_matches_reference():
    """A stacked leaf of (2, 10000, 10001), 200,020,000 float32 elements,
    above the reference's 2e8: it is clipped group by group (``lax.map``),
    the second group's gradient spiked so the two clips differ.  About
    20 s and 5.2 GB of host memory (both packages, one after the other)."""
    shape = (2, 10000, 10001)
    rng = np.random.default_rng(3)
    p = rng.standard_normal(shape, dtype=np.float32)
    g = rng.standard_normal(shape, dtype=np.float32)
    g[1] *= np.where(rng.random(shape[1:]) < 1e-3, 100, 1).astype(np.float32)
    norm = np.ones((4,), np.float32)
    ref_p, ref_s = ref_adafactor.adafactor_update(
        {"final_norm": jnp.asarray(norm), "layers": {"0": {"w": p}}},
        {"final_norm": jnp.asarray(norm), "layers": {"0": {"w": g}}},
        ref_adafactor.adafactor_init(
            {"final_norm": norm, "layers": {"0": {"w": p}}}), lr=1e-2)
    exp_w = np.asarray(ref_p["layers"]["0"]["w"])
    exp_s = {k: np.asarray(v)
             for k, v in ref_s["stats"]["layers"]["0"]["w"].items()}
    del ref_p, ref_s
    tp = {"final_norm": torch.from_numpy(norm),
          "layers": [{"w": torch.from_numpy(p[i])} for i in range(2)]}
    tg = {"final_norm": torch.from_numpy(norm),
          "layers": [{"w": torch.from_numpy(g[i])} for i in range(2)]}
    got_p, got_s = adafactor_update(tp, tg, adafactor_init(tp), lr=1e-2)
    for i in range(2):
        _assert_update_close(got_p["layers"][i]["w"], exp_w[i], p[i],
                             f"group {i}")
    for k, v in got_s["stats"]["layers"]["0"]["w"].items():
        assert v.shape == exp_s[k].shape == (2, 10000 if k == "vr" else 10001)
        _assert_update_close(v, exp_s[k], msg=k)


def test_adafactor_unstacked_leaves_and_defaults():
    """A tree of plain leaves (a 1-D vector, a matrix) and no layers, with
    a weight decay: the reference's update, leaf for leaf."""
    rng = np.random.default_rng(5)
    tree = {"v": rng.standard_normal((7,)).astype(np.float32),
            "m": rng.standard_normal((5, 9)).astype(np.float32)}
    grad = {k: rng.standard_normal(a.shape).astype(np.float32)
            for k, a in tree.items()}
    rp, rs = ref_adafactor.adafactor_update(
        tree, grad, ref_adafactor.adafactor_init(tree), lr=0.1, wd=0.5)
    t = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}
    gp, gs = adafactor_update(t(tree), t(grad), adafactor_init(t(tree)),
                              lr=0.1, wd=0.5)
    for k in tree:
        _assert_update_close(gp[k], rp[k], tree[k], k)
        for s in rs["stats"][k]:
            _assert_update_close(gs["stats"][k][s], rs["stats"][k][s], msg=s)
    assert int(gs["step"]) == 1


# ---------------------------------------------------------- compression
def _compress_tree(rng):
    """Leaves with many ties (small integers, so equal magnitudes of both
    signs straddle the threshold), a bf16 leaf and one whose k rounds
    down to 0 (so k = 1)."""
    return {
        "ties": rng.integers(-4, 5, (64, 33)).astype(np.float32),
        "normal": rng.standard_normal((300,)).astype(np.float32),
        "tiny": rng.standard_normal((3,)).astype(np.float32),
        "half": rng.standard_normal((16, 8)).astype(np.float32),
    }


@pytest.mark.parametrize("ratio", [0.01, 0.1, 0.5])
def test_topk_compress_matches_reference_bitwise(ratio):
    rng = np.random.default_rng(int(ratio * 100))
    grads = _compress_tree(rng)
    resid = {k: (rng.integers(-2, 3, a.shape) * 0.5).astype(np.float32)
             for k, a in grads.items()}
    ref_g = {k: jnp.asarray(a, jnp.bfloat16 if k == "half" else None)
             for k, a in grads.items()}
    rs, rr = ref_compress.topk_compress(
        ref_g, {k: jnp.asarray(a) for k, a in resid.items()}, ratio=ratio)
    tg = {k: torch.from_numpy(a).to(torch.bfloat16 if k == "half" else None)
          for k, a in grads.items()}
    ts, tr = topk_compress(tg, {k: torch.from_numpy(a)
                                for k, a in resid.items()}, ratio=ratio)
    for k in grads:
        for got, exp in ((ts[k], rs[k]), (tr[k], rr[k])):
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy().view(np.int32),
                                          np.asarray(exp).view(np.int32))
    k_ties = max(1, int(grads["ties"].size * ratio))
    assert int((ts["ties"] != 0).sum()) >= k_ties
    assert int((ts["tiny"] != 0).sum()) >= 1


def test_error_feedback_init_is_zero_float32():
    p = {"a": torch.ones((2, 3), dtype=torch.bfloat16), "b": [torch.ones(4)]}
    r = error_feedback_init(p)
    assert r["a"].dtype == r["b"][0].dtype == torch.float32
    assert not r["a"].any() and r["b"][0].shape == (4,)


# ------------------------------------------------------- pairwise tree
@pytest.mark.parametrize("shape", [(7, 13), (8, 64), (1, 5), (5, 3, 4),
                                   (2,)])
def test_ordered_tree_sum_matches_reference_bitwise(shape):
    x = (np.random.default_rng(sum(shape)).standard_normal(shape)
         * np.logspace(-3, 3, shape[-1])).astype(np.float32)
    exp = np.asarray(ref_reduce.ordered_tree_sum(jnp.asarray(x)))
    got = ordered_tree_sum(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), exp.view(np.int32))


# ------------------------------------------------ fixed-ring reduction
# 24 elements split evenly over 2 and 4 ranks, 13 need zero padding
RING_SHAPES = {"even": (4, 6), "padded": (13,)}

REF_RING = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, numpy as np
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as P
from repro.optim import ordered_ring_reduce
inputs, out = sys.argv[1:]
got = {}
with np.load(inputs) as data:
    for name in data.files:
        x = data[name]
        n = x.shape[0]
        mesh = Mesh(np.array(jax.devices()[:n]), ("data",))
        f = shard_map(lambda y: ordered_ring_reduce(y[0], "data")[None],
                      mesh=mesh, in_specs=P("data"), out_specs=P("data"),
                      check_rep=False)
        got[name] = np.asarray(f(x))
np.savez(out, **got)
"""


def test_ordered_ring_reduce_matches_reference_bitwise(tmp_path):
    """Four gloo ranks: a ring of 4 over the default group and rings of 2
    over two subgroups, each run again with one rank delayed before it
    joins.  Every rank's sum is bitwise equal to the reference's
    ``shard_map`` ring on 2 and 4 host devices (lengths that split evenly
    and that need zero padding), as is the one-process
    ``ordered_ring_sum`` of the stacked contributions, and within rtol
    1e-5 of a plain sum."""
    rng = np.random.default_rng(11)
    inputs = {f"{name}_w{n}": (rng.standard_normal((n,) + shape)
                               * 10.0 ** rng.integers(-4, 5, (n,) + shape)
                               ).astype(np.float32)
              for n in (2, 4) for name, shape in RING_SHAPES.items()}
    np.savez(tmp_path / "in.npz", **inputs)
    ref_out = tmp_path / "ref.npz"
    # the reference's ring runs beside the port's ranks
    ref = subprocess.Popen(
        [sys.executable, "-c", REF_RING, str(tmp_path / "in.npz"),
         str(ref_out)], env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    _torch_dist.spawn(_torch_dist.ring_worker, 4, tmp_path / "rdv",
                      tmp_path / "in.npz", tmp_path / "out")
    _, err = ref.communicate(timeout=300)
    assert ref.returncode == 0, err[-2000:]
    with np.load(ref_out) as exp:
        for rank in range(4):
            with np.load(tmp_path / f"out.{rank}.npz") as got:
                for key, x in inputs.items():
                    me = rank % x.shape[0]
                    for tag in ("", "_delayed"):
                        np.testing.assert_array_equal(
                            got[key + tag].view(np.int32),
                            exp[key][me].view(np.int32),
                            err_msg=f"{key}{tag} on rank {rank}")
                    np.testing.assert_allclose(
                        got[key], x.sum(0, dtype=np.float64), rtol=1e-5,
                        atol=1e-30)
        for key, x in inputs.items():
            np.testing.assert_array_equal(
                ordered_ring_sum(torch.from_numpy(x)).numpy().view(np.int32),
                exp[key][0].view(np.int32), err_msg=f"{key} in one process")


def test_ring_without_a_process_group_is_one_rank():
    x = torch.arange(6.0)
    assert ring_position() == (1, 0)
    assert ordered_ring_reduce(x) is x
    with pytest.raises(RuntimeError, match="not initialised"):
        ordered_ring_reduce(x, group=object())


# ------------------------------------------------------------ straggler
@pytest.mark.parametrize("n,stragglers,tail,seed", [
    (32, 4, 10.0, 9), (24, 6, 10.0, 0), (100, 0, 10.0, 3), (7, 7, 2.5, 1)])
def test_simulate_arrivals_matches_reference(n, stragglers, tail, seed):
    got = straggler.simulate_arrivals(n, n_stragglers=stragglers,
                                      tail_factor=tail, seed=seed)
    np.testing.assert_array_equal(got, ref_straggler.simulate_arrivals(
        n, n_stragglers=stragglers, tail_factor=tail, seed=seed))
    assert sorted(got.tolist()) == list(range(n))


def test_commit_deadline_policy_matches_reference():
    for seq_no in range(0, 30):
        for gv in (0, 4, 9):
            for max_stale in (0, 3, 8):
                assert straggler.commit_deadline_policy(
                    seq_no, gv, max_stale=max_stale) == \
                    ref_straggler.commit_deadline_policy(
                        seq_no, gv, max_stale=max_stale)
