"""Sensor imagery: 12-bit images as little-endian uint16 samples.

Stands in for Silesia's mr and x-ray.  Each image is a correlated random
walk along its rows and down its columns, plus uniform sensor noise, with a dark border (the share
of samples outside a centred disc is set to a low noise floor).
"""

from __future__ import annotations

import numpy as np


def generate(rng: np.random.Generator, nbytes: int, params: dict) -> bytes:
    side = int(params["side"])
    step = int(params["step"])
    n_img = nbytes // (2 * side * side) + 1
    yy, xx = np.mgrid[0:side, 0:side]
    r = np.hypot(yy - side / 2, xx - side / 2)
    outside = r > side * params["disc_radius"]
    out = []
    for _ in range(n_img):
        rows = np.cumsum(rng.integers(-step, step + 1, (side, side)), axis=1)
        cols = np.cumsum(rng.integers(-step, step + 1, (side, 1)), axis=0)
        noise = rng.integers(0, int(params["noise"]) + 1, (side, side))
        img = rows + cols + noise + int(rng.integers(1024, 3072))
        img[outside] = rng.integers(0, 4, int(outside.sum()))
        out.append(np.clip(img, 0, 4095).astype("<u2"))
    return np.concatenate(out).view(np.uint8).ravel()[:nbytes].tobytes()
