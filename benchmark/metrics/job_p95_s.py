"""s: the 95th percentile of the wall time of every job in the window,
from the call to ``compress`` to its return (``statistics.quantiles``,
n = 20, the exclusive method)."""

import statistics


def read(run):
    p = run.parts.get("window")
    times = [d.seconds for d in p.window.completed] if p else []
    return statistics.quantiles(times, n=20)[18] if len(times) >= 2 else None
