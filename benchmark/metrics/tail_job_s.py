"""s: the 95th percentile of the wall time of every job in the part of
the traced window with ``EncodeStats`` alone, from the call to
``compress`` to its return (``statistics.quantiles``, n = 20).  The
per-layer reading of ``job_p95_s`` in a cell whose runs spread too widely
for that metric's bound."""

import statistics


def read(run):
    p = run.parts.get("host")
    times = [d.seconds for d in p.window.completed] if p else []
    return statistics.quantiles(times, n=20)[18] if len(times) >= 2 else None
