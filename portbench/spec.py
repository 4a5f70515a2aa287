"""A cell of ``BENCHMARK.json`` and the files it names, found by name.

- ``portbench/workloads/<cell>.json``: the entry, the accounting family,
  the checked steps and the limits of the comparison;
- ``portbench/configs/<config>.json``: the model configuration, its
  sizes as run under ``run``;
- ``portbench/traffic/<traffic>.json``: the traffic mix's parameters;
- ``portbench/entries/<entry>.py``, ``portbench/accounting/<family>.py``,
  ``portbench/metrics/<metric>.py``, ``portbench/end_to_end/<metric>.py``:
  code found by the names above.

A later cell, configuration or metric adds files and entries; none of
these needs an edit.
"""
from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


def benchmark() -> dict:
    return _json(ROOT / "BENCHMARK.json")


def module(kind: str, name: str):
    """``portbench/<kind>/<name>.py``, loaded once as
    ``portbench.<kind>.<name>`` (dots and dashes of the name as ``_``)."""
    key = f"portbench.{kind}.{name.replace('.', '_').replace('-', '_')}"
    if key not in sys.modules:
        path = HERE / kind / f"{name}.py"
        if not path.is_file():
            raise FileNotFoundError(f"no {kind} file {path}")
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return sys.modules[key]


def _listed(metrics: list, cell: str) -> list:
    return [m for m in metrics if cell in m.get("workloads", [cell])]


def load(cell: str, bench: dict | None = None) -> dict:
    """Everything a run of ``cell`` reads, by name."""
    bench = bench or benchmark()
    found = [w for w in bench["workloads"] if w["name"] == cell]
    if not found:
        raise KeyError(f"no cell {cell!r} in BENCHMARK.json")
    entry = found[0]
    workload = _json(HERE / "workloads" / f"{cell}.json")
    return {
        "name": cell,
        "chips": entry["chips"],
        "workload": workload,
        "config": _json(HERE / "configs" / f"{entry['config']}.json"),
        "traffic": _json(HERE / "traffic" / f"{entry['traffic']}.json"),
        "end_to_end": _listed(bench["end_to_end"], cell),
        "per_layer": _listed(bench["per_layer"], cell),
    }
