"""bits/B: 8 x all output bytes over all input bytes of the jobs
completed in the window."""


def read(run):
    p = run.parts.get("window")
    done = p.window.completed if p else []
    if not done:
        return None
    return 8 * sum(len(d.out) for d in done) / sum(d.size for d in done)
