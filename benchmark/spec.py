"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration (its file is
``configs[].file``) and a traffic mix (``traffic/<traffic>.json``); each
metric is read by ``metrics/<name>.py``.  Adding a cell, a mix or a
metric adds files and entries and edits none.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parent        # the benchmark's folder
REPO = ROOT.parent                            # the checkout's root


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic_name: str
    end_to_end: list
    per_layer: list


def load(repo: Path = REPO) -> dict:
    with open(repo / "BENCHMARK.json") as f:
        return json.load(f)


def _applies(metric: dict, cell: str, reported: set[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported


def cell(bench: dict, name: str, repo: Path = REPO) -> Cell:
    """The cell ``name`` with its configuration file read and the metrics
    it reports."""
    wl = {w["name"]: w for w in bench["workloads"]}
    if name not in wl:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(wl)}")
    w = wl[name]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(repo / cfg["file"]) as f:
        config = json.load(f)
    e2e = [m for m in bench["end_to_end"] if _applies(m, name, set())]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _applies(m, name, reported)]
    return Cell(name, int(w["chips"]), config, w["traffic"], e2e, per_layer)


def reader(metric: str, root: Path = ROOT):
    """The module ``metrics/<metric>.py``; its ``read(run)`` gives the
    metric's value, or None where the run holds nothing to read."""
    path = root / "metrics" / f"{metric}.py"
    mod = f"{__package__}.metrics.{metric.replace('.', '_').replace('-', '_')}"
    spec = importlib.util.spec_from_file_location(mod, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
