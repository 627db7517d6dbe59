"""A configuration, a traffic mix or a metric added as files in a copy
of the benchmark is found by its name, with no edit to the harness."""

from __future__ import annotations

import json

from benchmark import pool, spec

from conftest import copy_benchmark, tiny_traffic


def test_added_files_are_found_by_name(tmp_path):
    repo = copy_benchmark(tmp_path)
    before = {p.relative_to(repo): p.read_bytes() for p in (repo / "benchmark").glob("*.py")}
    b = repo / "benchmark"
    (b / "configs" / "bzip2-5.json").write_text(json.dumps(
        {"name": "bzip2-5", "level": 5, "block_bytes": 500000, "device": "cuda", "compress": {"batch": 8}}))
    (b / "traffic" / "small-mix.json").write_text(json.dumps(tiny_traffic()))
    (b / "metrics" / "jobs_done.py").write_text(
        "def read(run):\n    return float(len(run.parts['window'].window.done))\n")
    bench = json.loads((repo / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "bzip2-5", "source": "s", "file": "benchmark/configs/bzip2-5.json",
                             "reduced": [], "why": "w"})
    bench["workloads"].append({"name": "l5-mix", "config": "bzip2-5", "traffic": "small-mix",
                               "chips": 1, "why": "w"})
    bench["per_layer"].append({"name": "jobs_done", "unit": "jobs", "better": "higher",
                               "source": "host_clock", "layer": "scheduler device thread",
                               "moves": "throughput", "workloads": ["l5-mix"]})
    (repo / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.cell(spec.load(repo), "l5-mix", repo)
    assert cell.config["level"] == 5 and cell.traffic_name == "small-mix"
    assert "jobs_done" in [m["name"] for m in cell.per_layer]
    assert "jobs_done" not in [m["name"] for m in spec.cell(spec.load(repo), "l9-silesia", repo).per_layer]
    parts = pool.build_pool(pool.load_traffic("small-mix", b), 1, b)
    assert sum(map(len, parts)) == 1 << 20

    class Run:
        parts = {"window": type("P", (), {"window": type("W", (), {"done": [1, 2, 3]})})}
    assert spec.reader("jobs_done", b).read(Run) == 3.0
    after = {p.relative_to(repo): p.read_bytes() for p in (repo / "benchmark").glob("*.py")}
    assert before == after


def test_each_cell_reports_the_tail_where_it_holds():
    bench = spec.load()
    l9, l1 = spec.cell(bench, "l9-silesia"), spec.cell(bench, "l1-silesia")
    assert "job_p95_s" not in [m["name"] for m in l9.end_to_end]
    assert "tail_job_s" in [m["name"] for m in l9.per_layer]
    assert "job_p95_s" in [m["name"] for m in l1.end_to_end]
    assert "tail_job_s" not in [m["name"] for m in l1.per_layer]
