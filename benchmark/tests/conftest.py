"""Fixtures of the benchmark's CPU tests: a tiny cell in a copy of the
benchmark, which the harness runs on the CPU."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

# Two intra-op threads a test process: the port's CPU device path then
# keeps its pace beside other test processes instead of spinning for cores.
torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

TINY_CONFIG = {"name": "tiny-cpu", "source": "a test configuration", "level": 1,
               "block_bytes": 100000, "device": "cpu", "compress": {"batch": 8}}


def tiny_traffic(name: str = "silesia-mix") -> dict:
    with open(REPO / "benchmark" / "traffic" / f"{name}.json") as f:
        t = json.load(f)
    t.update(pool_bytes=1 << 20, job_bytes={"min": 131072, "max": 393216, "classes": 3})
    return t


def copy_benchmark(dst: Path) -> Path:
    """A checkout-like copy: ``BENCHMARK.json`` and ``benchmark/``."""
    shutil.copytree(REPO / "benchmark", dst / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", dst / "BENCHMARK.json")
    return dst


@pytest.fixture
def tiny_repo(tmp_path):
    """A copy with one more cell, ``tiny``: level 1 on the CPU, jobs of
    64-256 KiB from a 1 MiB pool."""
    repo = copy_benchmark(tmp_path)
    (repo / "benchmark" / "configs" / "tiny-cpu.json").write_text(json.dumps(TINY_CONFIG))
    (repo / "benchmark" / "traffic" / "tiny-mix.json").write_text(json.dumps(tiny_traffic()))
    bench = json.loads((repo / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-cpu", "source": "a test configuration",
                             "file": "benchmark/configs/tiny-cpu.json", "reduced": [],
                             "why": "CPU tests"})
    bench["workloads"].append({"name": "tiny", "config": "tiny-cpu", "traffic": "tiny-mix",
                               "chips": 1, "why": "CPU tests"})
    (repo / "BENCHMARK.json").write_text(json.dumps(bench))
    return repo


def run_tiny(repo: Path, seed: int, seconds: float = 2.0, **kw) -> dict:
    import time

    from benchmark import harness, spec

    cell = spec.cell(spec.load(repo), "tiny", repo)
    return harness.run_cell(cell, seed, seconds, False, t0=time.perf_counter(),
                            root=repo / "benchmark", nproc=1, **kw)
