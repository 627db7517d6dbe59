"""ms/MB: the entropy-plan stage on the card's clock (``device_ms["plan"]``
of ``EncodeStats``: from the CUDA event after RLE2 to the one after the
plan, on the compute stream, with no added synchronisation) per input MB,
in the part of the traced window with ``EncodeStats`` alone."""


def read(run):
    p = run.parts.get("host")
    device_ms = getattr(p.stats, "device_ms", None) if p else None
    if not p or not p.mb or "plan" not in (device_ms or {}):
        return None
    return device_ms["plan"] / p.mb
