"""What decides ``correct``: the window's own streams against the plain
reference.

Once the window has closed, every stream it completed is decoded by the
standard library's ``bz2``, an independent decoder, and compared with
its job's bytes.  A sample of the jobs, drawn from the seed, with the
largest of them and, where the cell has several device threads, a job
that each of them worked on always in it, is encoded again by the NumPy
reference (``reference/``) from the job's bytes, and each of those
streams is compared with the reference's byte for byte.  Both run in one
pool of spawned processes.  Every number compared has its limit here.
"""

from __future__ import annotations

import bz2
import hashlib
import multiprocessing
import os

import numpy as np

from .reference.encoder import FULL_PLAN, compress_many

SAMPLE = 3        # jobs compared with the reference per run, besides one per device thread

# name -> (rule, limit): the run is correct when every number keeps it.
LIMITS = {
    "failed_jobs": ("<=", 0),
    "checked_jobs": (">=", 1),
    "stream_mismatch_jobs": ("<=", 0),
    "roundtrip_jobs": (">=", 1),
    "roundtrip_fail_jobs": ("<=", 0),
}


def sample(done: list, seed: int, k: int = SAMPLE) -> list:
    """The largest completed job, ``k - 1`` others drawn from the seed,
    and for each device thread that no job picked so far worked on, one
    drawn from the jobs it did work on."""
    done = [d for d in done if d.out is not None]
    if not done:
        return []
    rng = np.random.default_rng([int(seed) % 2**63, 5])
    largest = max(range(len(done)), key=lambda i: (done[i].size, -i))
    rest = [i for i in range(len(done)) if i != largest]
    pick = [largest] + sorted(rest[int(i)] for i in
                              rng.choice(len(rest), size=min(k - 1, len(rest)), replace=False))
    for dev in range(max((len(d.devices) for d in done), default=0)):
        ran = lambda i: len(done[i].devices) > dev and done[i].devices[dev] > 0  # noqa: E731
        if not any(ran(i) for i in pick):
            on = [i for i in range(len(done)) if ran(i)]
            if on:
                pick.append(on[int(rng.integers(len(on)))])
    return [done[i] for i in pick]


def workers() -> int:
    return max(1, min(16, len(os.sched_getaffinity(0))))


def digest(data: bytes) -> bytes:
    return hashlib.blake2b(data, digest_size=16).digest()


def decodes_to(args) -> bool:
    """Whether a stream decodes, with ``bz2``, to bytes of this digest."""
    stream, want = args
    try:
        return digest(bz2.decompress(stream)) == want
    except (OSError, ValueError, EOFError):
        return False


def verify(done: list, failed: int, pool: list, level: int, seed: int,
           nproc: int | None = None, plan=FULL_PLAN) -> dict:
    """The numbers compared: {name: value}.  ``nproc`` processes (inline
    for 1) decode every stream and encode the sample's blocks; every
    process has ended when this returns."""
    completed = [d for d in done if d.out is not None]
    trips = [(d.out, digest(d.job.data(pool))) for d in completed]
    picked = sample(done, seed)
    datas = [d.job.data(pool) for d in picked]
    nproc = workers() if nproc is None else nproc
    if nproc <= 1:
        decoded = list(map(decodes_to, trips))
        want = compress_many(datas, level, plan=plan)
    else:
        procs = multiprocessing.get_context("spawn").Pool(nproc)
        try:
            pending = procs.map_async(decodes_to, trips, chunksize=4)
            want = compress_many(datas, level, procs, plan=plan)
            decoded = pending.get()
        finally:
            procs.close()
            procs.join()
    return {"failed_jobs": failed, "checked_jobs": len(picked),
            "stream_mismatch_jobs": sum(d.out != w for d, w in zip(picked, want)),
            "roundtrip_jobs": len(trips), "roundtrip_fail_jobs": decoded.count(False)}


def judge(values: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "rule", "limit"}})."""
    out, ok = {}, True
    for name, (rule, limit) in LIMITS.items():
        v = values[name]
        ok &= v <= limit if rule == "<=" else v >= limit
        out[name] = {"value": v, "rule": rule, "limit": limit}
    return ok, out
