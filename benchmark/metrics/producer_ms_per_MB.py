"""ms/MB: the producer thread's host steps (``host_ms`` ``rle1_iter``,
``stage``, ``hardness_sort``, ``host_tiny`` of ``EncodeStats``) per input
MB, in the part of the traced window with ``EncodeStats`` alone."""

STEPS = ("rle1_iter", "stage", "hardness_sort", "host_tiny")


def read(run):
    p = run.parts.get("host")
    if p is None or not p.mb:
        return None
    return sum(p.stats.host_ms.get(s, 0.0) for s in STEPS) / p.mb
