"""ms/MB: the card's idle time between batches (``device_ms["gap"]`` of
``EncodeStats``: from the CUDA event that ends a batch on the compute
stream to the one that starts the next, both recorded for the same
``EncodeStats``) per input MB, in the part of the traced window with
``EncodeStats`` alone.  The gap before a call's first batch counts too,
so it holds the caller's own time between jobs (the harness builds the
next job and reads ``/proc`` there) and the start of the call's threads,
besides the scheduler's."""


def read(run):
    p = run.parts.get("host")
    device_ms = getattr(p.stats, "device_ms", None) if p else None
    if not p or not p.mb or "gap" not in (device_ms or {}):
        return None
    return device_ms["gap"] / p.mb
