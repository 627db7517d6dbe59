"""ms/MB: the time the device thread was off the CPU inside ``dispatch``:
``host_ms`` less ``cpu_ms`` of ``dispatch``, from ``EncodeStats``' wall
and thread CPU times of its one span a batch.  That is the wait for the
interpreter lock, which the thread lets go around each torch call, and
the operating system's.  Its waits for the card (``sync``) are not in it:
CUDA's default schedule spins on the CPU while it waits when a process
has fewer CUDA contexts than the host has cores.  Per input MB, in the
part of the traced window with ``EncodeStats`` alone."""


def read(run):
    p = run.parts.get("host")
    cpu_ms = getattr(p.stats, "cpu_ms", None) if p else None
    if not p or not p.mb or "dispatch" not in (cpu_ms or {}):
        return None
    return (p.stats.host_ms["dispatch"] - cpu_ms["dispatch"]) / p.mb
