"""The one general traffic generator: a pool of bytes, and jobs cut from it.

A traffic file (``traffic/<name>.json``) gives the pool's size, its
categories (each a share of the pool, a generator found by name in
``generators/`` and that generator's parameters) and the job sizes.
Everything is drawn from the run's seed, so one seed gives one pool and
one job sequence.

Job sizes come in rounds: each round holds the same ``classes`` sizes,
spaced evenly in log between ``min`` and ``max`` (the midpoints of equal
log-width classes, so a long run is log-uniform), in an order shuffled
by the seed.  A job is an archive of the categories in their shares:
from each category's part of the pool, a slice of that share of the
job's size at a seeded offset, the slices in a seeded order.  Every
seed therefore sends the same sizes of the same mix, and only the order
and the bytes change.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent


def load_traffic(name: str, root: Path = ROOT) -> dict:
    with open(root / "traffic" / f"{name}.json") as f:
        return json.load(f)


def generator(name: str, root: Path = ROOT):
    """The generator module ``generators/<name>.py`` under ``root``."""
    spec = importlib.util.spec_from_file_location(
        f"{__package__}.generators.{name}", root / "generators" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % 2**63, *stream])


def _split(total: int, shares: list[float]) -> list[int]:
    sizes = [int(round(s * total)) for s in shares]
    sizes[-1] += total - sum(sizes)
    return sizes


def build_pool(traffic: dict, seed: int, root: Path = ROOT) -> list[bytes]:
    """The pool: each category's part, in the traffic file's order."""
    cats = traffic["categories"]
    sizes = _split(int(traffic["pool_bytes"]), [c["share"] for c in cats])
    parts = []
    for i, (cat, size) in enumerate(zip(cats, sizes)):
        data = generator(cat["generator"], root).generate(_rng(seed, 1, i), size, cat["params"])
        if len(data) != size:
            raise RuntimeError(f"generator {cat['generator']} gave {len(data)} of {size} bytes")
        parts.append(data)
    return parts


def size_classes(traffic: dict) -> np.ndarray:
    j = traffic["job_bytes"]
    k = int(j["classes"])
    lo, hi = np.log(j["min"]), np.log(j["max"])
    return np.round(np.exp(lo + (np.arange(k) + 0.5) / k * (hi - lo))).astype(np.int64)


@dataclass(frozen=True)
class Job:
    size: int
    pieces: tuple        # (category, offset, length), in the job's order

    def data(self, pool: list[bytes]) -> bytes:
        return b"".join(pool[c][o : o + n] for c, o, n in self.pieces)


def jobs(traffic: dict, seed: int):
    """The endless job sequence of ``seed``."""
    classes = size_classes(traffic)
    shares = [c["share"] for c in traffic["categories"]]
    parts = _split(int(traffic["pool_bytes"]), shares)
    rng = _rng(seed, 4)
    while True:
        for size in classes[rng.permutation(len(classes))]:
            pieces = []
            for c, n in enumerate(_split(int(size), shares)):
                pieces.append((c, int(rng.integers(0, parts[c] - n + 1)), n))
            order = rng.permutation(len(pieces))
            yield Job(int(size), tuple(pieces[k] for k in order if pieces[k][2]))
