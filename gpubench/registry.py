"""Finds the benchmark's parts by name and checks names and units.

Layout under ``gpubench/``, each unit a file of its own:

- ``BENCHMARK.json`` at the checkout's root: cells, metrics, configurations;
- ``configs/<config>.json``: a recipe as it is run (``config``), with its
  ``source``, ``reduced`` and ``assumed`` sizes;
- ``traffic/<mix>.json``: the parameters the one generator (``traffic.py``)
  reads, and the ``kind`` of cell the mix drives;
- ``kinds/<kind>.py``: the runner of a kind of cell (``train``, ``decode``);
- ``metrics/<metric>.py``: one per-layer metric, ``read(ctx) -> float or
  None``;
- ``kernels/<layer>.<name>.json``: kernel names that attribute profiler
  kernels to a layer;
- ``limits/<cell>.json``: the limit of each number that decides ``correct``.

A later cell, mix, metric or kernel table is added as files and entries;
nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

NAME_RE = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT_RE = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")


def check_name(name: str, what: str = "name") -> str:
    """``name`` if it is a valid benchmark name, else ``ValueError``."""
    if not isinstance(name, str) or not NAME_RE.fullmatch(name):
        raise ValueError(f"invalid {what} {name!r}: a letter, digit or _ "
                         "then at most 63 letters, digits, _, . and -")
    return name


def check_unit(unit: str) -> str:
    if not isinstance(unit, str) or not UNIT_RE.fullmatch(unit):
        raise ValueError(f"invalid unit {unit!r}: 1 to 16 letters, digits, "
                         "_, /, %, . and -")
    return unit


def _json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"no such benchmark file: {path}")
    return json.loads(path.read_text())


def load_benchmark(root: Path = ROOT) -> dict:
    """``BENCHMARK.json``, its names and units checked."""
    bench = _json(root / "BENCHMARK.json")
    for c in bench["configs"]:
        check_name(c["name"], "config name")
        for key in c["reduced"]:
            check_name(key, "reduced key")
    for w in bench["workloads"]:
        check_name(w["name"], "workload name")
        check_name(w["config"], "config name")
        check_name(w["traffic"], "traffic name")
    for m in bench["end_to_end"] + bench["per_layer"]:
        check_name(m["name"], "metric name")
        check_unit(m["unit"])
    return bench


def cell(bench: dict, name: str) -> dict:
    """The workload ``name`` of ``bench``, with its configuration entry."""
    check_name(name, "workload name")
    for w in bench["workloads"]:
        if w["name"] == name:
            conf = next(c for c in bench["configs"] if c["name"] == w["config"])
            return {**w, "config_entry": conf}
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def metrics_for(bench: dict, cell_name: str, section: str) -> List[dict]:
    """The metrics of ``section`` (``end_to_end`` or ``per_layer``) that
    ``cell_name`` reports: those without ``workloads`` and those that list
    it."""
    return [m for m in bench[section]
            if "workloads" not in m or cell_name in m["workloads"]]


def config(entry: dict, root: Path = ROOT) -> dict:
    """A configuration's file (``BENCHMARK.json``'s ``file``)."""
    path = (root / entry["file"]).resolve()
    if HERE not in path.parents:
        raise ValueError(f"config file {entry['file']} is outside gpubench/")
    return _json(path)


def traffic(name: str) -> dict:
    return _json(HERE / "traffic" / f"{check_name(name, 'traffic name')}.json")


def limits(cell_name: str) -> Dict[str, float]:
    return _json(HERE / "limits" / f"{check_name(cell_name, 'cell name')}.json")


def _module(path: Path, label: str) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(f"no such benchmark module: {path}")
    spec = importlib.util.spec_from_file_location(
        f"gpubench._{label}_" + re.sub(r"\W", "_", path.stem), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kind(name: str) -> ModuleType:
    """The runner of cells of kind ``name`` (``kinds/<name>.py``)."""
    return _module(HERE / "kinds" / f"{check_name(name, 'kind')}.py", "kind")


def metric_reader(name: str) -> ModuleType:
    """The reader of the per-layer metric ``name`` (``metrics/<name>.py``)."""
    return _module(HERE / "metrics" / f"{check_name(name, 'metric name')}.py",
                   "metric")


def kernel_tables() -> Dict[str, List[str]]:
    """``{layer: [kernel names]}`` from every ``kernels/<layer>.<name>.json``
    (a list of names); tables of one layer are merged."""
    out: Dict[str, List[str]] = {}
    for path in sorted((HERE / "kernels").glob("*.json")):
        layer = check_name(path.stem, "kernel table").split(".")[0]
        names = _json(path)
        if not isinstance(names, list) or not all(
                isinstance(n, str) and re.fullmatch(r"\w+", n) for n in names):
            raise ValueError(f"{path}: a JSON list of kernel identifiers")
        out.setdefault(layer, []).extend(names)
    return out
