"""The benchmark's description, read from ``BENCHMARK.json`` and the
files it names.

Everything that belongs to one configuration, one traffic mix, one
per-layer metric or one model family sits in a file of its own, found
by name:

- a cell's configuration: the ``file`` of its entry in ``configs``
  (JSON; the port's own sizes under ``"port"``);
- its traffic: ``potbench/traffic/<traffic>.json``;
- its limits on the numbers that decide ``correct``:
  ``potbench/limits/<cell>.json``;
- a per-layer metric's reader: ``potbench/metrics/<metric>.py``, whose
  ``read(run)`` returns the value or None;
- the plain reference of a family: ``potbench/reference/<family>.py``.

A later cell, mix, metric or family is new files and new entries; no
file here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict        # the configuration's file
    traffic: dict       # the traffic mix's file
    limits: dict        # the limits of the numbers compared
    end_to_end: list    # this cell's entries of BENCHMARK.json
    per_layer: list


def read_json(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _named(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: Path, name: str) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files."""
    bench = read_json(root / "BENCHMARK.json")
    work = _named(bench["workloads"], name, "workload")
    conf = _named(bench["configs"], work["config"], "configuration")
    return Cell(
        name=name, chips=int(work["chips"]),
        config=read_json(root / conf["file"]),
        traffic=read_json(HERE / "traffic" / f"{work['traffic']}.json"),
        limits=read_json(HERE / "limits" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)])


def load_module(kind: str, name: str):
    """``potbench/<kind>/<name>.py`` as a module (a metric's reader or a
    family's reference); the file's name may hold dots."""
    path = HERE / kind / f"{name}.py"
    if not NAME.fullmatch(name) or not path.is_file():
        raise KeyError(f"no {kind} file for {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"potbench.{kind}.{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
