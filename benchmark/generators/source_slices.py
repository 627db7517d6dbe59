"""Source code: shifted slices of one frozen file of Python sources.

Stands in for Silesia's samba.  The file lies beside the traffic data
(``params["file"]``, relative to the benchmark's folder); each piece is
a slice of it from a seeded offset, wrapping at its end.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def generate(rng: np.random.Generator, nbytes: int, params: dict) -> bytes:
    src = (ROOT / params["file"]).read_bytes()
    lo, hi = params["slice_bytes"]
    out = bytearray()
    while len(out) < nbytes:
        start = int(rng.integers(0, len(src)))
        n = int(rng.integers(lo, hi + 1))
        piece = (src[start:] + src[:start]) * (n // len(src) + 1)
        out += piece[:n]
    return bytes(out[:nbytes])
