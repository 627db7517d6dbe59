"""Device time from a ``torch.profiler`` trace of one part of the window.

``profile`` and the interval union are copied from the port's
``chip_smoke.py`` (``trace``, ``profile_busy``); the summary adds what
the per-layer readers and the result's breakdown need: per-card busy
time, kernel counts and time by name, and the idle gaps, each named by
the host operation that launched the device work that ended it.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
import time
from collections import Counter, defaultdict
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def profile(fn, cuda: bool = True):
    """Run ``fn`` under torch.profiler (with the cards' activity when
    ``cuda``); return (its result, wall s, the trace's complete events)."""
    import torch
    from torch.profiler import ProfilerActivity, profile as _profile

    sync = torch.cuda.synchronize if cuda else (lambda: None)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync()
    with _profile(activities=acts) as prof:
        t0 = time.perf_counter()
        result = fn()
        sync()
        wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"]
                      if e.get("ph") == "X"]
    return result, wall, events


def union(spans) -> tuple[float, list]:
    """(covered length, merged spans) of (start, end) pairs."""
    merged = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1][1] = b
        else:
            merged.append([a, b])
    return sum(b - a for a, b in merged), merged


def short_name(name: str) -> str:
    """A kernel's ``*_kernel`` identifier where it has one, else the
    start of its name."""
    m = re.search(r"(\w+_kernel)\b", name)
    return m.group(1) if m else name[:64]


@dataclass
class TraceSummary:
    wall_s: float
    busy_s: dict                       # card -> union of device op time
    kernels: int                       # kernel events, all cards
    kernel_s: Counter = field(default_factory=Counter)   # short name -> s
    idle_gaps: Counter = field(default_factory=Counter)  # cause -> s

    @property
    def mean_busy_s(self) -> float:
        return sum(self.busy_s.values()) / max(1, len(self.busy_s))

    def kernel_time(self, pattern: str) -> float:
        """Seconds of the kernels whose name holds ``pattern``."""
        return sum(s for n, s in self.kernel_s.items() if pattern in n)


def summarize(events, wall_s: float, cards: list[int]) -> TraceSummary:
    ops = {}
    for e in events:
        if e.get("cat") == "cpu_op":
            ext = e.get("args", {}).get("External id")
            if ext is not None:
                ops[ext] = e["name"]
    per_card = defaultdict(list)
    kernel_s: Counter = Counter()
    kernels = 0
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        args = e.get("args", {})
        card = args.get("device", e.get("pid"))
        per_card[card].append((e["ts"], e["ts"] + e["dur"], args.get("External id"), e["name"]))
        if e["cat"] == "kernel":
            kernels += 1
            kernel_s[short_name(e["name"])] += e["dur"] / 1e6
    busy, gaps = {}, Counter()
    for card in cards:
        spans = sorted(per_card.get(card, []))
        covered, merged = union((a, b) for a, b, _x, _n in spans)
        busy[card] = covered / 1e6
        # Each gap between merged spans, named by what ends it.
        i = 0
        for (a0, b0), (a1, _b1) in zip(merged, merged[1:]):
            while spans[i][0] < a1:
                i += 1
            ext, name = spans[i][2], spans[i][3]
            cause = ops.get(ext) or short_name(name)
            gaps[f"before {cause}"] += (a1 - b0) / 1e6
    return TraceSummary(wall_s, busy, kernels, kernel_s, gaps)
