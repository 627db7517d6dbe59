"""ms/MB: the part of the card's idle time between batches in which the
device thread waited for the producer to stage the next batch
(``device_ms["gap_starved"]`` of ``EncodeStats``: for each gap the lesser
of the gap and that wait, which end together) per input MB, in the part
of the traced window with ``EncodeStats`` alone."""


def read(run):
    p = run.parts.get("host")
    device_ms = getattr(p.stats, "device_ms", None) if p else None
    if not p or not p.mb or "gap_starved" not in (device_ms or {}):
        return None
    return device_ms["gap_starved"] / p.mb
