"""kernels/MB: kernel events in the profiled part's trace per input MB."""


def read(run):
    p = run.parts.get("profile")
    if p is None or not p.mb or not p.trace.kernels:
        return None
    return p.trace.kernels / p.mb
