"""ms/MB: the device thread's batch body (``host_ms["dispatch"]`` of
``EncodeStats``, the host wall of launching one batch's stages) per input
MB, in the part of the traced window with ``EncodeStats`` alone."""


def read(run):
    p = run.parts.get("host")
    if p is None or not p.mb or "dispatch" not in p.stats.host_ms:
        return None
    return p.stats.host_ms["dispatch"] / p.mb
