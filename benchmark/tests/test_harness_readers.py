"""Every metric reader on a recorded profiler trace and EncodeStats."""

from __future__ import annotations

import json
import statistics
from pathlib import Path

import pytest

from banzai_tpu_torch.pipeline import EncodeStats
from benchmark import harness, pool, spec, tracing, window
from benchmark.peaks import HBM_BYTES_PER_S
from benchmark.reference.rle1 import iter_blocks

DATA = Path(__file__).resolve().parent / "data"


def recorded():
    with open(DATA / "trace_small.json") as f:
        d = json.load(f)
    return d["traceEvents"], d["wall_s"]


def brute_busy(events) -> float:
    """Covered seconds by a sweep over interval ends (an independent union)."""
    marks = sorted([(e["ts"], 1) for e in events] + [(e["ts"] + e["dur"], -1) for e in events])
    depth, last, busy = 0, None, 0.0
    for t, d in marks:
        if depth > 0:
            busy += t - last
        depth += d
        last = t
    return busy / 1e6


@pytest.fixture(scope="module")
def run():
    t = pool.load_traffic("silesia-mix")
    t["pool_bytes"] = 1 << 21
    t["job_bytes"] = {"min": 100_000, "max": 600_000, "classes": 3}
    parts = pool.build_pool(t, 9)
    jobs = [j for j, _ in zip(pool.jobs(t, 9), range(9))]
    done = [window.Done(j, 0.1 + 0.01 * k, b"x" * (j.size // 4)) for k, j in enumerate(jobs)]
    events, wall = recorded()
    cell = spec.cell(spec.load(), "l9-silesia")
    data = harness.RunData(cell, 9, 12.5, parts)
    w = window.Window
    data.parts["window"] = harness.Part(w(done, 2.0))
    host = EncodeStats()
    host.host_ms.update(rle1_iter=10.0, stage=20.0, hardness_sort=1.0, dispatch=300.0, drain=7.0)
    data.parts["host"] = harness.Part(w(done[:3], 1.0), host)
    data.parts["profile"] = harness.Part(w(done[3:6], wall), None, tracing.summarize(events, wall, [0]))
    stages = EncodeStats(stage_ms={"bwt": 40.0, "plan": 80.0, "mtf": 5.0})
    data.parts["stages"] = harness.Part(w(done[6:], 1.0), stages)
    return data


def read(name, run):
    return spec.reader(name).read(run)


def test_end_to_end_readers(run):
    done = run.parts["window"].window.done
    mb = sum(d.size for d in done) / 1e6
    assert read("throughput", run) == pytest.approx(mb / 2.0)
    assert read("job_p95_s", run) == pytest.approx(statistics.quantiles([d.seconds for d in done], n=20)[18])
    assert read("bits_per_byte", run) == pytest.approx(8 * sum(len(d.out) for d in done) / sum(d.size for d in done))
    assert read("setup_s", run) == 12.5


def test_host_step_readers(run):
    mb = run.parts["host"].mb
    times = [d.seconds for d in run.parts["host"].window.done]
    assert read("tail_job_s", run) == pytest.approx(statistics.quantiles(times, n=20)[18])
    assert read("dispatch_ms_per_MB", run) == pytest.approx(300.0 / mb)
    assert read("producer_ms_per_MB", run) == pytest.approx(31.0 / mb)


def test_stage_readers(run):
    mb = run.parts["stages"].mb
    assert read("bwt_ms_per_MB", run) == pytest.approx(40.0 / mb)
    assert read("plan_ms_per_MB", run) == pytest.approx(80.0 / mb)


def test_trace_readers(run):
    events, wall = recorded()
    dev = [e for e in events if e["cat"] in ("kernel", "gpu_memcpy", "gpu_memset")]
    kernels = [e for e in dev if e["cat"] == "kernel"]
    mb = run.parts["profile"].mb
    assert read("device_idle_share", run) == pytest.approx(100 * (1 - brute_busy(dev) / wall))
    assert read("kernels_per_MB", run) == pytest.approx(len(kernels) / mb)
    k1 = sum(e["dur"] for e in kernels if "mtf_shuffle" in e["name"]) / 1e6
    assert k1 > 0
    symbols = sum(len(b.output) for d in run.parts["profile"].window.done
                  for b in iter_blocks(d.job.data(run.pool), 9) if len(b.output) > 16384)
    share = read("k1_roofline_share", run)
    assert share == pytest.approx(100 * 2 * symbols / HBM_BYTES_PER_S / k1)
    assert 0 < share <= 100


def test_readers_return_nothing_without_their_part(run):
    empty = harness.RunData(run.cell, 9, 1.0, run.pool)
    for m in spec.load()["per_layer"]:
        assert read(m["name"], empty) is None
    for m in ("throughput", "job_p95_s", "bits_per_byte"):
        assert read(m, empty) is None


def test_summary_gaps_and_kernels():
    events, wall = recorded()
    s = tracing.summarize(events, wall, [0])
    dev = [e for e in events if e["cat"] in ("kernel", "gpu_memcpy", "gpu_memset")]
    busy = brute_busy(dev)
    span = (max(e["ts"] + e["dur"] for e in dev) - min(e["ts"] for e in dev)) / 1e6
    assert s.busy_s[0] == pytest.approx(busy)
    assert sum(s.idle_gaps.values()) == pytest.approx(span - busy)
    assert s.kernels == sum(e["cat"] == "kernel" for e in events)
    assert sum(s.kernel_s.values()) == pytest.approx(sum(e["dur"] for e in dev if e["cat"] == "kernel") / 1e6)
