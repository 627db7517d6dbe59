"""Wrap-around BWT of one block by prefix doubling, in NumPy.

The rotations are sorted first by their first 8 bytes (packed into one
uint64 key), then by doubling: each round sorts only the rotations whose
group of equal prefixes still holds more than one, by (group, rank of
the rotation ``h`` further on).  A rotation's rank is the start of its
group in the sorted order, so ranks stay consistent while groups split.
Equal rotations (a periodic block) stay tied; they give the same column
byte, and ``ptr`` is the start of rotation 0's group: the number of
rotations strictly smaller than it, as in the port.
"""

from __future__ import annotations

import numpy as np

PREFIX = 8   # bytes of each rotation in the first sort key


def bwt(block) -> tuple[np.ndarray, int]:
    """(column uint8 [n], ptr) of ``block`` (uint8 array or bytes)."""
    data = np.ascontiguousarray(np.frombuffer(bytes(block), np.uint8)
                                if not isinstance(block, np.ndarray)
                                else block, dtype=np.uint8)
    n = len(data)
    if n <= 1:
        return data.copy(), 0
    h = min(PREFIX, n)
    key = np.zeros(n, np.uint64)
    for j in range(h):
        key = (key << np.uint64(8)) | np.roll(data, -j).astype(np.uint64)
    sa = np.argsort(key)
    ks = key[sa]
    first = np.empty(n, bool)          # sa position starts a group
    first[0] = True
    np.not_equal(ks[1:], ks[:-1], out=first[1:])
    pos = np.arange(n, dtype=np.int64)
    head = np.maximum.accumulate(np.where(first, pos, 0))
    rank = np.empty(n, np.int64)
    rank[sa] = head
    while h < n:
        starts = np.flatnonzero(first)
        sizes = np.diff(np.append(starts, n))
        tied = sizes > 1
        if not tied.any():
            break
        act = np.flatnonzero(np.repeat(tied, sizes))
        elems = sa[act]
        comp = head[act] * n + rank[(elems + h) % n]
        order = np.argsort(comp)
        elems = elems[order]
        comp = comp[order]
        sa[act] = elems
        brk = np.empty(len(act), bool)
        brk[0] = True
        np.not_equal(comp[1:], comp[:-1], out=brk[1:])
        first[act] = brk
        hd = np.maximum.accumulate(np.where(brk, act, 0))
        head[act] = hd
        rank[elems] = hd
        h *= 2
    return data[(sa - 1) % n], int(rank[0])
