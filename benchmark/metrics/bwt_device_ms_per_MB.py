"""ms/MB: the BWT stage on the card's clock (``device_ms["bwt"]`` of
``EncodeStats``: from the CUDA event after the upload to the one after
the BWT, on the compute stream, with no added synchronisation) per input
MB, in the part of the traced window with ``EncodeStats`` alone."""


def read(run):
    p = run.parts.get("host")
    device_ms = getattr(p.stats, "device_ms", None) if p else None
    if not p or not p.mb or "bwt" not in (device_ms or {}):
        return None
    return device_ms["bwt"] / p.mb
