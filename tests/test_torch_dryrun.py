"""The port's dry run (``repro_torch.launch.dryrun``) on the ``meta``
device: its parameter tree holds the reference's element count for all
ten full configurations; its FLOP and saved-activation counts equal
those of a real run on the CPU (smoke configurations, train, prefill and
decode); ``extrapolate`` from one and two pattern groups equals the full
count; and its records carry the keys the reference's
``terms_from_record`` reads."""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.configs import get_config as ref_get_config
from repro.launch import roofline_model as ref_roofline
from repro.models import lm as ref_lm
from repro_torch.configs import ARCHS, SHAPES, ShapeSpec, get_config
from repro_torch.configs import get_smoke_config
from repro_torch.launch import dryrun, roofline_model
from repro_torch.launch.dryrun import count_cell
from repro_torch.models import lm
from repro_torch.tree import leaves


def _elements(tree) -> int:
    return sum(int(np.prod(t.shape)) for t in leaves(tree)) if isinstance(
        tree, (dict, list)) else 0


@pytest.mark.parametrize("arch", ARCHS)
def test_meta_leaf_count_matches_reference(arch):
    """``cfg.param_count()`` is analytical and misses some leaves (the
    roofline's N), so the parity is with the reference's own tree."""
    cfg = get_config(arch)
    got = lm.init_params(None, cfg, dtype=torch.float32, device="meta")
    assert all(t.device.type == "meta" for t in leaves(got))
    shapes = jax.eval_shape(
        lambda: ref_lm.init_params(jax.random.PRNGKey(0),
                                   ref_get_config(arch)))
    want = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    assert sum(t.numel() for t in leaves(got)) == want


def test_init_params_device_is_meta_only():
    with pytest.raises(ValueError):
        lm.init_params(None, get_smoke_config("stablelm-12b"), device="cpu")


CELLS = {"train": ShapeSpec("t", "train", 32, 4),
         "prefill": ShapeSpec("p", "prefill", 32, 2),
         "decode": ShapeSpec("d", "decode", 64, 2)}


@pytest.mark.parametrize("mode", list(CELLS))
@pytest.mark.parametrize("arch", ["stablelm-12b", "deepseek-moe-16b",
                                  "whisper-medium"])
def test_meta_counts_equal_a_real_cpu_run(arch, mode):
    cfg = get_smoke_config(arch)
    shape = CELLS[mode]
    dtype = torch.float32 if mode == "train" else torch.bfloat16
    n_mb = 2 if mode == "train" else 1
    meta = count_cell(cfg, shape, lm.init_params(
        None, cfg, dtype=dtype, device="meta"), n_mb=n_mb)
    real = count_cell(cfg, shape, lm.init_params(
        torch.Generator().manual_seed(0), cfg, dtype=dtype), n_mb=n_mb)
    assert meta["flops"] == real["flops"] > 0
    assert meta["saved_bytes"] == real["saved_bytes"]
    assert (meta["saved_bytes"] > 0) == (mode == "train")


def _counts_at(cfg, n_groups, shape, sizes):
    cut = dataclasses.replace(cfg, n_layers=n_groups * len(cfg.pattern))
    params = lm.init_params(None, cut, dtype=torch.float32, device="meta")
    out = count_cell(cut, shape, params)
    prof = dryrun.profile_for(sizes, shape)
    out["collectives"] = dryrun.collective_bytes(
        cut, shape, params, lm.param_specs(cut, prof), prof, sizes, 1)
    return out


@pytest.mark.parametrize("mode", ["train", "prefill"])
@pytest.mark.parametrize("arch", ["stablelm-12b", "recurrentgemma-9b"])
def test_extrapolate_equals_full_depth(arch, mode):
    cfg = get_smoke_config(arch)
    shape = CELLS[mode]
    sizes = {"data": 2, "model": 8}
    s1, s2, s3 = (_counts_at(cfg, g, shape, sizes) for g in (1, 2, 3))
    full = dataclasses.replace(cfg, n_layers=3 * len(cfg.pattern))
    ex = dryrun.extrapolate(s1, s2, dryrun.depth_units(full))
    assert ex["flops"] == s3["flops"]
    assert ex["bytes"] == s3["bytes"]
    for k, v in s3["collectives"].items():
        assert ex["collectives"][k] == pytest.approx(v, rel=1e-12), k


def test_cli_records_carry_the_reference_keys(tmp_path, capsys):
    dryrun.main(["--arch", "mamba2-370m", "--shape", "long_500k",
                 "--cards", "16", "--link-bw", "4.5e11",
                 "--out-dir", str(tmp_path)])
    dryrun.main(["--arch", "stablelm-12b", "--shape", "long_500k",
                 "--cards", "16", "--link-bw", "4.5e11",
                 "--out-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "SKIP stablelm_12b/long_500k" in out
    assert [p.name for p in tmp_path.iterdir()] == [
        "mamba2_370m__long_500k.json"]
    rec = json.loads((tmp_path / "mamba2_370m__long_500k.json").read_text())
    for key in ("single_pod", "multi_pod"):
        assert rec[key]["meta"]["mesh"] == {"single_pod": "2x8",
                                            "multi_pod": "2x1x8"}[key]
        assert rec[key]["memory"]["fits"] is True
    # the reference's roofline reads the port's record
    want = ref_roofline.terms_from_record(rec)
    got = roofline_model.terms_from_record(
        rec, roofline_model.h100(16, link_bw=4.5e11))
    assert got["flops_per_chip"] == want["flops_per_chip"]
    assert got.keys() >= want.keys()
    assert rec["roofline"] == json.loads(json.dumps(got))


def test_train_memory_model():
    """The per-card peak of a train cell: the functional apply holds the
    old and new parameters and state beside the gradient sum."""
    cfg = get_config("stablelm-12b")
    shape = SHAPES["train_4k"]
    cut = dataclasses.replace(cfg, n_layers=2)
    params = lm.init_params(None, cut, dtype=torch.float32, device="meta")
    sizes = {"data": 8, "model": 8}
    prof = dryrun.profile_for(sizes, shape)
    pspecs = lm.param_specs(cut, prof)
    counts = {"saved_bytes": 0.0, "largest_bytes": 0.0}
    mem = dryrun.memory_per_card(cut, shape, params, pspecs, prof, sizes,
                                 counts, optimizer="adamw", n_mb=4)
    p = mem["param_bytes"]
    assert mem["opt_bytes"] == 2 * p + 4          # m, v and the step
    assert mem["grad_bytes"] == 2 * p              # f32 sum + the step's own
    assert mem["peak_bytes"] == 2 * p + 2 * mem["opt_bytes"] + p
    # FSDP over data and TP over model: 1/64 of the layers' weights, 1/8
    # of the vocab tables (over the model axis only)
    n = sum(t.numel() for t in leaves(params))
    assert n * 4 / 64 < p < n * 4 / 8
    no_fsdp = dataclasses.replace(prof, fsdp=False)
    assert dryrun.tree_local_bytes(params, lm.param_specs(cut, no_fsdp),
                                   sizes) > p
