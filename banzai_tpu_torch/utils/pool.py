"""Spawn-context process pools for the host encoder's workers.

Counterpart of ``banzai_tpu/utils/pool.py``.  The workers of both the
host block-parallel pool (``encoder_host``) and the hybrid host+device
scheduler (``pipeline``) are NumPy-only.  Fork is never used: the parent
typically holds CUDA runtime and scheduler threads, and forking a
multithreaded process deadlocks (see the CPython docs on fork and
threads).  Spawned workers re-import by module path, which is why the
worker functions live in torch-free modules and the package's
``__init__`` imports torch only when an encode needs it.
"""

from __future__ import annotations

import multiprocessing as mp


def spawn_pool(jobs: int) -> "mp.pool.Pool":
    """A spawn-context Pool of ``jobs`` workers."""
    return mp.get_context("spawn").Pool(jobs)
