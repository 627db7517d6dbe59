"""The closed loop: one caller sends one job after another.

Each job is the bytes of one slice of the pool, made before its clock
starts; its time runs from the call to the encoder to its return.  Jobs
start until ``seconds`` have passed, and the window closes when the last
one started returns, so every job in it completes and the window's
wall time holds all of their work.  With the encoder's ``EncodeStats``,
each job also records how many batches each device thread ran for it.
"""

from __future__ import annotations

import sys
import time
import traceback
from dataclasses import dataclass

from . import hostload


@dataclass
class Done:
    job: object              # pool.Job
    seconds: float
    out: bytes | None        # None: the encoder raised
    at: float = 0.0          # s from the window's start to the job's return
    devices: tuple = ()      # batches each device thread ran for the job
    host: tuple = ()         # hostload.snapshot() at the job's return

    @property
    def size(self) -> int:
        return self.job.size


@dataclass
class Window:
    done: list
    wall_s: float
    start: float = 0.0       # perf_counter at the window's start
    host: tuple = ()         # hostload.snapshot() at the window's start

    @property
    def attempted(self) -> int:
        return len(self.done)

    @property
    def completed(self) -> list:
        return [d for d in self.done if d.out is not None]

    @property
    def failed(self) -> int:
        return sum(d.out is None for d in self.done)

    @property
    def input_bytes(self) -> int:
        return sum(d.size for d in self.completed)


def run(jobs, pool: list, encode, seconds: float, stats=None) -> Window:
    """Drive ``encode(data) -> bytes`` with ``jobs`` for ``seconds``;
    ``stats`` is the ``EncodeStats`` that ``encode`` fills, if any."""
    done = []
    job = next(jobs)
    data = job.data(pool)
    host = hostload.snapshot()
    start = time.perf_counter()
    end = start + seconds
    while True:
        t0 = time.perf_counter()
        if t0 >= end:
            break
        before = list(stats.device_batches) if stats is not None else []
        try:
            out = encode(data)
        except Exception:
            traceback.print_exc(file=sys.stderr)
            out = None
        last = time.perf_counter()
        devices = ()
        if stats is not None:
            before += [0] * (len(stats.device_batches) - len(before))
            devices = tuple(a - b for a, b in zip(stats.device_batches, before))
        done.append(Done(job, last - t0, out, last - start, devices, hostload.snapshot()))
        job = next(jobs)
        data = job.data(pool)
    return Window(done, last - start, start, host)
