"""Published peak of one NVIDIA H100 SXM (NVIDIA's data sheet, at its
700 W power limit), as the port's ``chip_smoke.py`` has it."""

HBM_BYTES_PER_S = 3.35e12   # device memory


def bound_s(nbytes: float) -> float:
    """The least seconds to move ``nbytes`` once through device memory."""
    return nbytes / HBM_BYTES_PER_S
