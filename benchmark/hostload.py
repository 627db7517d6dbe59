"""Where the host's time went, by quarter of a window: printed, not a metric.

A run's MB/s can swing between quarters of one window and between runs
of one seed.  To tell a slower host from a program that waits, each job's
end records the process's CPU seconds and the garbage collector's time,
and every thread started under ``recording`` adds its own CPU seconds,
by name, at its end.  A job and a thread are booked to the quarter in
which they end.
"""

from __future__ import annotations

import gc
import os
import re
import threading
import time
from contextlib import contextmanager

_threads: list = []      # (name, cpu_s, perf_counter at its end)
_gc = [0.0, 0.0]         # [seconds in collections, start of the current one]


def snapshot() -> tuple:
    """(process CPU s, GC s)."""
    t = os.times()
    return (t.user + t.system, _gc[0])


def _on_gc(phase, info):
    if phase == "start":
        _gc[1] = time.perf_counter()
    else:
        _gc[0] += time.perf_counter() - _gc[1]


@contextmanager
def recording():
    """Book every thread started inside, and the GC's time."""
    run = threading.Thread.run

    def timed_run(self):
        t = time.thread_time()
        try:
            run(self)
        finally:
            _threads.append((self.name, time.thread_time() - t, time.perf_counter()))

    _threads.clear()
    threading.Thread.run = timed_run
    gc.callbacks.append(_on_gc)
    try:
        yield
    finally:
        threading.Thread.run = run
        gc.callbacks.remove(_on_gc)


def tasks() -> dict:
    """{thread id: (its name, CPU s)} of every thread of this process now
    (Linux ``/proc``; empty elsewhere).  Threads that live through a
    window, such as the caller's, CUDA's and the thread pools', are not
    booked by ``recording``: this reads them."""
    out = {}
    tick = os.sysconf("SC_CLK_TCK")
    try:
        for tid in os.listdir("/proc/self/task"):
            with open(f"/proc/self/task/{tid}/stat") as f:
                head, rest = f.read().rsplit(")", 1)
            fields = rest.split()
            out[int(tid)] = (head.split("(", 1)[1], (int(fields[11]) + int(fields[12])) / tick)
    except (OSError, ValueError, IndexError):
        pass
    return out


def lived_through(before: dict, after: dict) -> str:
    """One line: CPU s, by name, of the threads alive at both readings;
    the main thread apart."""
    main = os.getpid()
    by: dict = {}
    for tid, (name, cpu) in after.items():
        if tid in before:
            key = "main" if tid == main else name
            n, s = by.get(key, (0, 0.0))
            by[key] = (n + 1, s + cpu - before[tid][1])
    return "threads alive all window, cpu s: " + ", ".join(
        f"{k} x{n}: {s:.2f}" for k, (n, s) in sorted(by.items(), key=lambda kv: -kv[1][1]))


def by_quarter(done: list, start: float, wall: float, before: tuple) -> str:
    """One line: per quarter of the window, the MB done, the process's and
    the named threads' CPU seconds, and the GC's seconds."""
    q = lambda at: min(3, int(4 * at / wall)) if wall > 0 else 0  # noqa: E731
    mb = [0.0] * 4
    last = [before] * 4
    for d in done:
        mb[q(d.at)] += d.size / 1e6
        last[q(d.at)] = d.host
    for i in range(1, 4):          # a quarter with no job end keeps the last reading
        if last[i] is before:
            last[i] = last[i - 1]
    edges = [before] + last
    diff = [[b - a for a, b in zip(edges[i], edges[i + 1])] for i in range(4)]
    threads: dict = {}
    for name, cpu, end in _threads:
        if start <= end <= start + wall + 1e-3:
            threads.setdefault(re.sub(r"\d+$", "", name), [0.0] * 4)[q(end - start)] += cpu
    r = lambda xs: [round(x, 3) for x in xs]  # noqa: E731
    return (f"host by quarter: MB {r(mb)}; process cpu s {r(d[0] for d in diff)}; "
            f"threads cpu s {{{', '.join(f'{k}: {r(v)}' for k, v in sorted(threads.items()))}}}; "
            f"gc s {r(d[1] for d in diff)}")
