"""The port's examples (``repro_torch.examples``) run in-process on the
CPU and print their reference counterparts' claims.  ``quickstart`` and
``det_replay_debug`` print exactly what ``examples/quickstart.py`` and
``examples/det_replay_debug.py`` print (each run here too); the serving
example's weights are the port's own draws, so its claims are checked
line by line."""

import pathlib
import re
import runpy

import pytest
import torch

torch.set_num_threads(1)

from repro_torch.examples import (det_replay_debug, failover, quickstart,
                                  serve_batch)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _run(module, capsys) -> str:
    module.main(["--device", "cpu"])
    return capsys.readouterr().out


@pytest.mark.parametrize("module,script", [
    (quickstart, "quickstart.py"), (det_replay_debug, "det_replay_debug.py")],
    ids=["quickstart", "det_replay_debug"])
def test_example_prints_what_the_reference_prints(module, script, capsys):
    out = _run(module, capsys)
    runpy.run_path(str(ROOT / "examples" / script), run_name="__main__")
    ref = capsys.readouterr().out.replace("—", "--")
    assert out == ref


def test_quickstart_claims(capsys):
    out = _run(quickstart, capsys)
    occ = int(re.search(r"OCC outcomes .*: (\d+) distinct", out)[1])
    assert occ > 1
    assert re.search(r"Pot outcomes .*: 1 distinct", out)
    assert re.search(r"Pot == serial oracle\s*: True", out)
    assert re.search(r"record/replay reproduces OCC run\s*: True", out)


def test_det_replay_debug_claims(capsys):
    out = _run(det_replay_debug, capsys)
    assert int(re.search(r"bug manifested in (\d+)/8", out)[1]) > 0
    assert "bug reproduces 5/5 runs" in out
    assert "correct 5/5 runs" in out


def test_serve_batch_claims(capsys):
    out = _run(serve_batch, capsys)
    fps = re.findall(r"replica \d: state fingerprint (0x[0-9a-f]+)", out)
    assert len(fps) == 2 and fps[0] == fps[1]
    assert "replicas bitwise identical: True" in out
    assert "bucketed store + commit log bitwise identical" in out
    ingress = re.findall(r"replica [ABC]: .*fingerprint (0x[0-9a-f]+)", out)
    assert len(ingress) == 3 and len(set(ingress)) == 1
    assert "all replicas bitwise identical" in out


def test_failover_claims(capsys):
    out = _run(failover, capsys)
    assert "SIGKILLed at (batch 4, 'execute') -- rc -9" in out
    a = re.search(r"replica A .*fingerprint (0x[0-9a-f]+)", out)[1]
    b = re.search(r"replica B restarted: .*fingerprint (0x[0-9a-f]+)", out)[1]
    assert a == b
    assert "recovery == uninterrupted" in out
