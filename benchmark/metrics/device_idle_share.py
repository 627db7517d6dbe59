"""%: 100 x (1 - the union of kernel, memcpy and memset intervals over the
wall of the profiled part of the window), the mean over the cards."""


def read(run):
    p = run.parts.get("profile")
    if p is None or p.trace.wall_s <= 0 or not p.trace.kernels:
        return None
    return 100.0 * (1.0 - p.trace.mean_busy_s / p.trace.wall_s)
