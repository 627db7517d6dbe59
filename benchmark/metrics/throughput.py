"""MB/s: the input bytes of every job completed in the window over the
window's wall time (MB = 10^6 B)."""


def read(run):
    p = run.parts.get("window")
    return None if p is None or not p.window.completed else p.mb / p.window.wall_s
