"""Vectorised pieces shared by the traffic generators."""

from __future__ import annotations

import numpy as np


def zipf_ranks(rng: np.random.Generator, n: int, s: float, size: int) -> np.ndarray:
    """``size`` draws from ranks 0..n-1 with P(k) proportional to
    1 / (k + 1) ** s."""
    cdf = np.cumsum(1.0 / np.arange(1, n + 1, dtype=np.float64) ** s)
    return np.searchsorted(cdf, rng.random(size) * cdf[-1], side="right")


def gather(source: np.ndarray, starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Concatenate ``source[starts[i] : starts[i] + lens[i]]`` for every i."""
    starts = np.asarray(starts, np.int64)
    lens = np.asarray(lens, np.int64)
    ends = np.cumsum(lens)
    idx = np.arange(int(ends[-1]) if len(ends) else 0, dtype=np.int64)
    idx += np.repeat(starts - (ends - lens), lens)
    return source[idx]


def table(entries: list[bytes]) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(concatenated bytes, starts, lengths) of a list of byte strings."""
    lens = np.array([len(e) for e in entries], np.int64)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    return np.frombuffer(b"".join(entries), np.uint8), starts, lens


def emit(rng: np.random.Generator, entries: list[bytes], s: float, nbytes: int) -> bytes:
    """At least ``nbytes`` of entries drawn by Zipf popularity, cut to
    ``nbytes``."""
    src, starts, lens = table(entries)
    mean = float(lens.mean())
    out = np.zeros(0, np.uint8)
    while len(out) < nbytes:
        k = zipf_ranks(rng, len(entries), s, int((nbytes - len(out)) / mean * 1.1) + 16)
        out = np.concatenate([out, gather(src, starts[k], lens[k])])
    return out[:nbytes].tobytes()
