"""Database tables: fixed-width records with repeated fields.

Stands in for Silesia's nci, osdb and sao.  A share of each chunk is
ASCII rows: a zero-padded running id, a code and a name from small
Zipf-popular sets (from the parameters' ``table_seed``, the same for
every run), a decimal amount, a date that advances, a flag, space
padding.  The rest of the chunk is binary rows (sao's share of the
category): two float64 coordinates that wander slowly, an int32 id that
counts up, two int16 fields from a small set.
"""

from __future__ import annotations

import numpy as np

from ..gen_util import zipf_ranks


def _digits(values: np.ndarray, width: int) -> np.ndarray:
    """[n, width] ASCII digits of non-negative integers, zero-padded."""
    pw = 10 ** np.arange(width - 1, -1, -1, dtype=np.int64)
    return ((values[:, None] // pw) % 10 + ord("0")).astype(np.uint8)


def _words(rng, n: int, count: int, width: int) -> np.ndarray:
    """[count, width] upper-case words, space padded."""
    lens = rng.integers(3, width + 1, count)
    w = (rng.integers(0, 26, (count, width)) + ord("A")).astype(np.uint8)
    w[np.arange(width)[None, :] >= lens[:, None]] = ord(" ")
    return w


def _ascii(rng, nbytes: int, p: dict) -> np.ndarray:
    width = int(p["ascii_width"])
    n = nbytes // width + 1
    rows = np.full((n, width), ord(" "), np.uint8)
    rows[:, 0:8] = _digits(np.arange(n) + int(rng.integers(0, 10**6)), 8)
    table = np.random.default_rng(p["table_seed"])
    codes = _words(table, n, int(p["codes"]), 6)
    rows[:, 9:15] = codes[zipf_ranks(rng, len(codes), 1.2, n)]
    names = _words(table, n, int(p["names"]), 20)
    rows[:, 16:36] = names[zipf_ranks(rng, len(names), 1.0, n)]
    rows[:, 37:47] = _digits(rng.integers(0, 10**9, n), 10)
    rows[:, 44] = ord(".")
    day = np.cumsum(rng.random(n) < 0.01) + 20000101
    rows[:, 48:56] = _digits(day, 8)
    rows[:, 57] = np.where(rng.random(n) < 0.9, ord("Y"), ord("N"))
    rows[:, width - 1] = ord("\n")
    return rows.ravel()[:nbytes]


def _binary(rng, nbytes: int, p: dict) -> np.ndarray:
    rec = np.dtype([("ra", "<f8"), ("dec", "<f8"), ("id", "<i4"),
                    ("mag", "<i2"), ("cls", "<i2")])
    n = nbytes // rec.itemsize + 1
    r = np.zeros(n, rec)
    r["ra"] = np.round(np.cumsum(rng.random(n)) * 1e-3, 6)
    r["dec"] = np.round(np.cumsum(rng.normal(0, 1e-3, n)), 6)
    r["id"] = np.arange(n) + int(rng.integers(0, 10**6))
    r["mag"] = rng.integers(-150, 1500, n) // 10 * 10
    r["cls"] = rng.choice(np.array(p["binary_classes"], np.int16), n)
    return r.view(np.uint8)[:nbytes]


def generate(rng: np.random.Generator, nbytes: int, params: dict) -> bytes:
    # The two kinds of table alternate in chunks, so that every slice of
    # a few chunks holds both in their shares.
    chunk = int(params["chunk_bytes"])
    ca = int(round(chunk * params["ascii_share"]))
    n = -(-nbytes // chunk)
    a = _ascii(rng, n * ca, params).reshape(n, ca)
    b = _binary(rng, n * (chunk - ca), params).reshape(n, chunk - ca)
    return np.concatenate([a, b], axis=1).ravel()[:nbytes].tobytes()
