"""s: from the start of the process to the first timed job: imports, the
CUDA context, the kernel library, the corpus pool and the warm-up."""


def read(run):
    return run.setup_s
