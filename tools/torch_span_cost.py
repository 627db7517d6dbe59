"""What the scheduler's spans and marks cost on the device thread, and a
cross-check of the card's stage times against the synchronised ones.

    python tools/torch_span_cost.py [--device cuda] [--seconds 20]

Prints, as lines of JSON:

* ``alone``: the µs of one span (wall clock only, and with the thread CPU
  clock), one mark, one empty ``with``, and ``read_int`` and ``int`` of a
  host scalar, each in a loop of its own on a
  thread bound as a device thread is, with and without a second thread
  busy in Python;
* ``in_place``: over ``--seconds`` of ``bzip2 -9`` and ``-1`` jobs of the
  benchmark's ``silesia-mix`` traffic, for each of span creation, entry
  and exit and marks: the calls a device batch makes, the µs the device
  thread spends in them a batch, and the median and 99th percentile µs of
  one call (read by wrappers whose own clock reads lie outside the
  interval), and the ``read_int`` calls a batch makes.  The means hold
  the waits for the interpreter lock that land in these calls; an event
  record gives the lock up, as every torch call on the thread does;
* ``spin``: the thread CPU ms over a host read that waits ~50 ms for the
  card, against its wall ms (CUDA's wait spins on the CPU or sleeps);
* ``cross``: per level, ``device_ms`` over ``stage_ms`` of ``bwt`` and
  ``plan`` in calls with ``EncodeStats(stage_ms={})``.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch

import banzai_tpu_torch
from banzai_tpu_torch import spans
from banzai_tpu_torch.pipeline import EncodeStats
from benchmark import pool


def alone(dev, n=20_000) -> dict:
    rec = spans.Recorder(EncodeStats())
    out = {}

    def loops():
        rec.bind(0, None)
        t = time.perf_counter()
        for _ in range(n):
            with spans._NULL:
                pass
        out["with"] = time.perf_counter() - t
        for key, cpu in (("span", False), ("span_cpu", True)):
            t = time.perf_counter()
            for _ in range(n):
                with spans.span("x", cpu):
                    pass
            out[key] = time.perf_counter() - t
        one = torch.tensor(1)
        for key, fn in (("int", int), ("read_int", spans.read_int)):
            t = time.perf_counter()
            for _ in range(n):
                fn(one)
            out[key] = time.perf_counter() - t
        if dev.type == "cuda":
            stream = torch.cuda.current_stream(dev)
            free = []
            tl = spans.Timeline(stream, free)
            t = time.perf_counter()
            for i in range(n):
                tl.mark(None)
                if i % 6 == 5:              # a batch's six, given back
                    free.extend(ev for _n, ev in tl.marks)
                    tl.marks.clear()
            out["mark"] = time.perf_counter() - t
            torch.cuda.synchronize(dev)

    res = {}
    for busy in (False, True):
        stop = threading.Event()

        def spin():
            x = 0
            while not stop.is_set():
                x += 1

        other = threading.Thread(target=spin) if busy else None
        if other:
            other.start()
        th = threading.Thread(target=loops)
        th.start()
        th.join()
        stop.set()
        if other:
            other.join()
        res["busy" if busy else "idle"] = {
            k: round(1e6 * v / n, 3) for k, v in out.items()}
    return res


def in_place(dev, level: int, seconds: float, seed: int) -> dict:
    traffic = pool.load_traffic("silesia-mix")
    data = pool.build_pool(traffic, seed)
    jobs = pool.jobs(traffic, seed)
    acc = {k: [] for k in ("init", "enter", "exit", "mark", "read")}
    pc = time.perf_counter
    init, enter, exit_, mark = (spans.Span.__init__, spans.Span.__enter__,
                                spans.Span.__exit__, spans.Timeline.mark)
    on = threading.local()

    def wrap(key, fn):
        def w(*a):
            if not getattr(on, "device", False):
                return fn(*a)
            t0 = pc()
            r = fn(*a)
            acc[key].append(pc() - t0)
            return r
        return w

    from banzai_tpu_torch.ops import bwt
    read_int = getattr(bwt, "read_int", None)      # counted, priced alone

    def read_w(t):
        if getattr(on, "device", False):
            acc["read"].append(0.0)
        return read_int(t)

    bind = spans.Recorder.bind

    def bind_w(self, batch=-1, timeline=None):
        on.device = threading.current_thread().name.endswith("device0")
        return bind(self, batch, timeline)

    banzai_tpu_torch.compress(next(jobs).data(data), level, str(dev),
                              EncodeStats())       # warm up
    spans.Span.__init__ = wrap("init", init)
    spans.Span.__enter__ = wrap("enter", enter)
    spans.Span.__exit__ = wrap("exit", exit_)
    spans.Timeline.mark = wrap("mark", mark)
    spans.Recorder.bind = bind_w
    if read_int is not None:
        bwt.read_int = read_w
    stats = EncodeStats()
    t_end = time.perf_counter() + seconds
    nbytes = 0
    try:
        while time.perf_counter() < t_end:
            job = next(jobs).data(data)
            nbytes += len(job)
            banzai_tpu_torch.compress(job, level, str(dev), stats)
    finally:
        spans.Span.__init__ = init
        spans.Span.__enter__, spans.Span.__exit__ = enter, exit_
        spans.Timeline.mark, spans.Recorder.bind = mark, bind
        if read_int is not None:
            bwt.read_int = read_int
    b = max(stats.batches, 1)
    out = {"level": level, "batches": stats.batches, "MB": nbytes / 1e6,
           "dispatch_ms_per_batch": stats.host_ms["dispatch"] / b}
    for k, v in acc.items():
        out[k] = {"per_batch": round(len(v) / b, 2)}
        if v and k != "read":
            v = sorted(v)
            out[k].update(
                us_per_batch=round(1e6 * sum(v) / b, 2),
                median_us=round(1e6 * v[len(v) // 2], 2),
                p99_us=round(1e6 * v[int(0.99 * (len(v) - 1))], 2))
    return out


def spin(dev) -> dict:
    x = torch.ones(1, device=dev)
    torch.cuda.synchronize(dev)
    out = []
    for _ in range(5):
        torch.cuda._sleep(100_000_000)      # ~50 ms of clock cycles
        y = x * 2
        t, c = time.perf_counter(), time.thread_time()
        int(y.item())
        out.append((1e3 * (time.thread_time() - c),
                    1e3 * (time.perf_counter() - t)))
    return {"cpu_ms": [round(c, 2) for c, _ in out],
            "wall_ms": [round(w, 2) for _, w in out]}


def cross(dev, seed: int) -> list:
    traffic = pool.load_traffic("silesia-mix")
    data = pool.build_pool(traffic, seed)
    job = b"".join(data)[: 8 << 20]
    rows = []
    for level in (9, 1):
        for _ in range(2):
            st = EncodeStats(stage_ms={})
            banzai_tpu_torch.compress(job, level, str(dev), st)
            rows.append({"level": level, **{
                k: round(st.device_ms[k] / st.stage_ms[k], 4)
                for k in ("bwt", "plan")}})
    return rows


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=2147483701)
    ap.add_argument("--parts", default="alone,in_place,spin,cross",
                    help="which of the parts to run, comma-separated")
    a = ap.parse_args()
    parts = a.parts.split(",")
    dev = torch.device(a.device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    if "alone" in parts:
        print(json.dumps({"alone": alone(dev)}), flush=True)
    if "in_place" in parts:
        for level in (9, 1):
            print(json.dumps({"in_place": in_place(
                dev, level, a.seconds, a.seed + level)}), flush=True)
    if dev.type == "cuda" and "spin" in parts:
        print(json.dumps({"spin": spin(dev)}), flush=True)
    if dev.type == "cuda" and "cross" in parts:
        print(json.dumps({"cross": cross(dev, a.seed)}), flush=True)


if __name__ == "__main__":
    main()
