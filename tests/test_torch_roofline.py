"""Parity of the port's roofline model (``repro_torch.launch.
roofline_model``) with the reference's (``repro.launch.roofline_model``)
when given the reference's constants: every function, all ten
architectures x four shapes, within 1e-12 relative.  The port's source
carries none of the reference's TPU numbers."""

import pathlib
import re

import pytest

from repro.launch import roofline_model as ref
from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.launch import dryrun, roofline_model

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF_MACHINE = roofline_model.Machine(
    peak_flops=ref.PEAK_FLOPS, hbm_bw=ref.HBM_BW, link_bw=ref.ICI_BW,
    chips=ref.CHIPS, model=ref.MODEL, data=ref.DATA)
RTOL = 1e-12


def _record(arch, shape, optimizer, n_mb):
    """A synthetic dry-run record: the keys ``terms_from_record`` reads."""
    coll = {"all-gather": 3.5e9, "all-reduce": 1.25e9,
            "reduce-scatter": 2.0e9, "all-to-all": 0.0,
            "collective-permute": 0.0, "ops": 412}
    coll["total"] = sum(v for k, v in coll.items() if k != "ops")
    coll["total_bf16_wire"] = 0.75 * coll["total"]
    return {"arch": arch, "shape": shape,
            "analysis": {"extrapolated": {"flops": 1.234e15,
                                          "bytes": 5.6e12,
                                          "collectives": coll}},
            "single_pod": {"meta": {"optimizer": optimizer,
                                    "n_microbatches": n_mb}}}


def _close(got, want, what):
    if isinstance(want, dict):
        assert got.keys() >= want.keys(), what
        for k in want:
            _close(got[k], want[k], f"{what}.{k}")
    elif isinstance(want, str):
        assert got == want, what
    else:
        assert abs(got - want) <= RTOL * abs(want), (what, got, want)


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_functions_match_reference(arch, shape):
    cfg = get_config(arch)
    spec = SHAPES[shape]
    _close(roofline_model.cache_bytes_per_chip(cfg, spec, REF_MACHINE),
           ref.cache_bytes_per_chip(cfg, spec), "cache_bytes_per_chip")
    for optimizer in ("adamw", "adafactor"):
        for n_mb in (1, 4, 8):
            for huge in (False, True):
                _close(roofline_model.modeled_memory_bytes(
                    cfg, spec, optimizer=optimizer, n_mb=n_mb, huge=huge,
                    machine=REF_MACHINE),
                    ref.modeled_memory_bytes(cfg, spec, optimizer=optimizer,
                                             n_mb=n_mb, huge=huge),
                    f"modeled_memory_bytes {optimizer} {n_mb} {huge}")
            rec = _record(arch, shape, optimizer, n_mb)
            got = roofline_model.terms_from_record(rec, REF_MACHINE)
            assert got["collective_unverified"] is True
            _close(got, ref.terms_from_record(rec), "terms_from_record")
    assert dryrun.choose_optimizer(cfg) == (
        "adafactor" if cfg.param_count() > 100e9 else "adamw")


def test_h100_machine():
    m = roofline_model.h100(64, link_bw=4.5e11)
    assert (m.chips, m.model, m.data) == (64, 8, 8)
    assert m.hbm_bw == 3.35e12 and m.peak_flops == 8.05e14
    assert roofline_model.h100(64, link_bw=1.0, multi_pod=True).data == 4


def test_port_source_carries_no_tpu_number():
    """The reference's v5e-class peaks (197e12 FLOP/s, 819e9 and 50e9
    bytes/s) appear nowhere in the port."""
    pat = re.compile(r"(?<![\w.])(197e12|819e9|50e9)(?![\w.])")
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    hits = [(f.name, m[0]) for f in files
            for m in pat.finditer(f.read_text())]
    assert not hits, hits
