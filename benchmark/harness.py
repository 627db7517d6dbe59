"""One run of one cell: set-up, the measured window, the check, the metrics.

``run_cell`` is everything of a run but the look for the cards, which
``run.py`` makes first; the tests drive it on the CPU.  With ``trace``
the window is cut into three parts, so that no instrument distorts
another's reading: ``host`` (``EncodeStats``' host step times alone),
``profile`` (``torch.profiler`` alone, a third of the window and at most
``PROFILE_S``, since its trace grows with every kernel) and ``stages``
(``EncodeStats`` with ``stage_ms``, whose stages synchronise the device);
the first and the last share the rest equally.
"""

from __future__ import annotations

import statistics
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from . import check, hostload, pool, spec, tracing, window

BANNED = {"jax", "jaxlib", "flax", "banzai_tpu"}   # whole top-level names
PROFILE_S = 5.0       # at most this much of a traced window runs under the profiler
# A configuration file's keys: those the harness runs by, and those only
# people read.  ``compress`` holds the keyword arguments of
# ``banzai_tpu_torch.compress`` besides the level, the device and the stats.
RUNS_BY = {"level", "block_bytes", "device", "compress"}
DESCRIBES = {"name", "source", "guarantees", "assumed", "why"}


@dataclass
class Part:
    window: window.Window
    stats: object = None
    trace: tracing.TraceSummary | None = None

    @property
    def mb(self) -> float:
        return self.window.input_bytes / 1e6


@dataclass
class RunData:
    """What the metric readers (``metrics/<name>.py``) read."""
    cell: spec.Cell
    level: int
    setup_s: float
    pool: list           # the cell's pool: one bytes part per category
    parts: dict = field(default_factory=dict)


def process_age_s() -> float | None:
    """Seconds since this process started, from /proc (Linux)."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        import os
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None


def cards(devices) -> list[int]:
    import torch

    devs = [devices] if isinstance(devices, str) else list(devices)
    out = []
    for d in devs:
        d = torch.device(d)
        out.append(torch.cuda.current_device() if d.index is None else d.index)
    return sorted(set(out))


def check_config(config: dict) -> None:
    """Refuse a configuration with a key the harness would not act on."""
    unknown = set(config) - RUNS_BY - DESCRIBES
    if unknown:
        raise ValueError(f"configuration keys the harness does not use: {sorted(unknown)}; "
                         f"arguments of compress go under 'compress'")


def program(config: dict, devices):
    """``encode(data, stats=None, device=None) -> bytes``: the port's
    public one-shot call at the configuration's level, with its
    ``compress`` arguments."""
    import banzai_tpu_torch

    level, kwargs = int(config["level"]), dict(config["compress"])

    def encode(data, stats=None, device=None):
        return banzai_tpu_torch.compress(
            data, level, devices if device is None else device, stats, **kwargs)
    return encode


def warm_jobs(config: dict, seed: int) -> list[bytes]:
    """Inputs whose batches take every row count the cell's jobs can
    dispatch (powers of two up to the batch: the first dispatch is a
    quarter batch, the next a full one, the last of a job the rest),
    from seeded random bytes, whose RLE1 blocks are full."""
    batch = int(config["compress"]["batch"])
    quarter = max(1, batch // 4)
    block = int(config["block_bytes"])
    rng = np.random.default_rng([int(seed) % 2**63, 6])
    counts, p = [], 1
    while p <= batch:
        counts.append(p if p <= quarter else quarter + batch + (p if p < batch else 0))
        p *= 2
    return [rng.integers(0, 256, n * block - block // 2, dtype=np.uint8).tobytes()
            for n in counts]


def warm_up(encode, config: dict, traffic: dict, pool_bytes: list, seed: int, devices) -> None:
    """Every dispatch shape on every device, then one job of the pool's
    bytes (a quarter and a full batch) on the cell's devices, which also
    leaves the word-fetch bucket at this content."""
    devs = [devices] if isinstance(devices, str) else list(devices)
    for d in devs:
        for data in warm_jobs(config, seed):
            encode(data, device=d)
    batch = int(config["compress"]["batch"])
    n = (max(1, batch // 4) + batch) * int(config["block_bytes"])
    encode(next(pool.jobs({**traffic, "job_bytes": {"min": n, "max": n, "classes": 1}}, seed)).data(pool_bytes))


def card_line() -> str:
    """Name and power limit of every card (nvidia-smi), or why not."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        return "; ".join(res.stdout.strip().splitlines()) or res.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, *,
             t0: float, devices=None, encode=None, warm: bool = True,
             root: Path = spec.ROOT, nproc: int | None = None) -> dict:
    """One run; returns the result line's object.  ``devices`` and
    ``encode`` replace the configuration's devices and the program;
    ``warm`` False skips the warm-up."""
    cfg = cell.config
    check_config(cfg)
    devices = cfg["device"] if devices is None else devices
    cuda = "cuda" in str(devices)
    traffic = pool.load_traffic(cell.traffic_name, root)
    pool_bytes = pool.build_pool(traffic, seed, root)
    if encode is None:
        encode = program(cfg, devices)
    cs = cards(devices) if cuda else [0]
    if warm:
        warm_up(encode, cfg, traffic, pool_bytes, seed, devices)
    setup_s = process_age_s() or (time.perf_counter() - t0)
    run = RunData(cell, int(cfg["level"]), setup_s, pool_bytes)
    jobs = pool.jobs(traffic, seed)
    from banzai_tpu_torch.pipeline import EncodeStats

    def timed(seconds, st=None):
        return window.run(jobs, pool_bytes, lambda d: encode(d, st), seconds, st)

    lived = hostload.tasks()
    with hostload.recording():
        if not trace:
            st = EncodeStats()
            run.parts["window"] = Part(timed(seconds, st), st)
        else:
            traced = min(seconds / 3, PROFILE_S)
            rest = (seconds - traced) / 2
            st = EncodeStats()
            run.parts["host"] = Part(timed(rest, st), st)
            w, wall, events = tracing.profile(lambda: timed(traced), cuda)
            run.parts["profile"] = Part(w, None, tracing.summarize(events, wall, cs))
            del events
            st = EncodeStats(stage_ms={})
            run.parts["stages"] = Part(timed(rest, st), st)

    print(hostload.lived_through(lived, hostload.tasks()), file=sys.stderr, flush=True)
    device = {"platform": "gpu" if cuda else "cpu", "count": len(cs)}
    if cuda:
        import torch
        torch.cuda.synchronize()
        device["kind"] = torch.cuda.get_device_name(cs[0])
        device["memory_peak_bytes"] = max(torch.cuda.max_memory_allocated(c) for c in cs)
    else:
        device["kind"] = "cpu"
        device["memory_peak_bytes"] = 0
    prof = run.parts.get("profile")
    if prof is not None:
        device["busy_s"] = prof.trace.mean_busy_s
        device["window_s"] = prof.trace.wall_s

    done = [d for p in run.parts.values() for d in p.window.done]
    attempted = sum(p.window.attempted for p in run.parts.values())
    failed = sum(p.window.failed for p in run.parts.values())
    report(run, cuda)
    # The reference runs on the host, after the peak memory was read.
    t = time.perf_counter()
    values = check.verify(done, failed, pool_bytes, run.level, seed, nproc)
    print(f"check: {values['roundtrip_jobs']} streams decoded, {values['checked_jobs']} jobs "
          f"against the reference in {time.perf_counter() - t:.2f} s", file=sys.stderr, flush=True)
    correct, checks = check.judge(values)

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = spec.reader(m["name"], root).read(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device}
    if prof is not None:
        t = prof.trace
        result["breakdown"] = {
            "device_ops": [[n, s] for n, s in t.kernel_s.most_common(10)],
            "idle_gaps": [[n, s] for n, s in t.idle_gaps.most_common(10)],
        }
    result["checks"] = checks
    return result


def report(run: RunData, cuda: bool) -> None:
    """The readings that are not metrics, on standard error."""
    say = lambda *a: print(*a, file=sys.stderr, flush=True)  # noqa: E731
    if cuda:
        say(f"cards: {card_line()}")
    say(f"setup_s {run.setup_s:.4f}")
    for name, p in run.parts.items():
        w = p.window
        times = [d.seconds for d in w.completed]
        p95 = statistics.quantiles(times, n=20)[18] if len(times) >= 2 else float("nan")
        say(f"part {name}: {len(w.done)} jobs, {w.input_bytes} B in {w.wall_s:.4f} s, "
            f"job median {statistics.median(times) if times else float('nan'):.4f} s, p95 {p95:.4f} s")
        say(f"  {hostload.by_quarter(w.completed, w.start, w.wall_s, w.host)}")
        st = p.stats
        if st is not None:
            say(f"  host_ms {st.host_ms}")
            say(f"  blocks: device {st.device_blocks}, host_tiny {st.host_tiny}, "
                f"host_capacity {st.host_capacity}, host_banzai {st.host_banzai}; "
                f"batches {st.batches} {st.device_batches}, refetches {st.refetches}")
            if st.stage_ms:
                say(f"  stage_ms {st.stage_ms}")
        if p.trace is not None:
            say(f"  trace: busy_s {p.trace.busy_s}, kernels {p.trace.kernels}, wall {p.trace.wall_s:.4f}")


def banned_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & BANNED)
