"""The benchmark as data, found by name.

``BENCHMARK.json`` at the checkout's root lists the configurations, cells
and metrics.  Under ``perfbench/``:

* ``configs/<config>.json``: a configuration as it is run (the file that
  ``BENCHMARK.json`` names), with the plain reference it is checked
  against (``reference``: a module of ``perfbench/reference/``);
* ``traffic/<mix>.json``: a traffic mix's parameters, read by
  ``bench/traffic.py``; its ``kind`` names the driver (``prefill``,
  ``decode``);
* ``checks/<cell>.json``: how a cell's output is compared with the
  reference (how much of it, and each number's limit);
* ``metrics/<metric>.py``: a per-layer metric's reader.

A later cell, mix, configuration or metric is new files and new entries.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Mapping

ROOT = Path(__file__).resolve().parents[2]


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    mix: Dict
    check: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]
    root: Path

    @property
    def kind(self) -> str:
        return self.mix["kind"]


def reports(metric: Mapping, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                         f"(known: {sorted(cells)})")
    w = cells[name]
    config = next(c for c in spec["configs"] if c["name"] == w["config"])
    bench = root / "perfbench"
    return Cell(
        name=name, chips=w["chips"],
        config=json.loads((root / config["file"]).read_text()),
        mix=json.loads((bench / "traffic" / f"{w['traffic']}.json")
                       .read_text()),
        check=json.loads((bench / "checks" / f"{name}.json").read_text()),
        end_to_end=[m for m in spec["end_to_end"] if reports(m, name)],
        per_layer=[m for m in spec["per_layer"] if reports(m, name)],
        root=root)


def reader(root: Path, metric: str):
    """The ``read`` function of ``perfbench/metrics/<metric>.py``."""
    path = root / "perfbench" / "metrics" / f"{metric}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def reference(cell: Cell):
    """The configuration's plain reference class."""
    mod_spec = importlib.util.spec_from_file_location(
        f"perfbench_reference_{cell.config['reference']}",
        cell.root / "perfbench" / "reference"
        / f"{cell.config['reference']}.py")
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.Reference
