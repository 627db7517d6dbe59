"""ms/MB: the device thread's waits for the card at its host reads of
device values (``host_ms["sync"]`` of ``EncodeStats``: the BWT's group
counts, K1's error read) per input MB, in the part of the traced window
with ``EncodeStats`` alone."""


def read(run):
    p = run.parts.get("host")
    if p is None or not p.mb or "sync" not in p.stats.host_ms:
        return None
    return p.stats.host_ms["sync"] / p.mb
