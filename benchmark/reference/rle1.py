"""RLE1: bzip2's first-pass run-length encoding and the block split.

The semantics of the port's host module of the same name, written
plainly for the benchmark's reference: NumPy only, nothing of the
program imported.

The reference machine (lib/rle.rs:102-253) walks the input two bytes an
iteration, writes each maximal run of 4 or more equal bytes as 4
literals and a count (at most 251, so a long run goes in chunks of at
most 255 input bytes), and stops when the block's output bound
(``100_000 * level - 1``) is spent, with its own rules for a run that
the bound cuts.  Away from that bound its output is a pure function of
the maximal runs: a run of length L is consumed in chunks of
min(255, rest), a chunk c >= 4 becomes 4 literals and c - 4, a shorter
one c literals.  So each block is emitted from its runs with NumPy up to
a point ``MARGIN`` output bytes before its bound, where the machine is
at the top of its loop in a known state, and the machine itself
(``machine_replay``) runs only from there.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .constants import block_capacity
from .crc32 import block_crc

MARGIN = 600          # output bytes before the bound where the machine takes over
MAX_IN_PER_OUT = 52   # a block never consumes more than this many input bytes per output byte


def machine_replay(
    data, i: int, floor: int, bound: int
) -> tuple[bytearray, int]:
    """Exact replay of the reference RLE1 loop (lib/rle.rs:133-240) from a
    loop-top state ``(i, floor)`` with ``bound`` output bytes remaining.

    ``data`` is the full input (bytes-like supporting int indexing); EOF is
    ``len(data)``.  Returns (emitted bytes, final input position).
    """
    out = bytearray()
    n = len(data)
    if i >= n:
        return out, i
    b = data[i]
    while True:
        if bound == 0:
            break
        if bound == 1:
            out.append(b)
            i += 1
            break
        out.append(b)
        bound -= 1

        d = n - i
        if d == 1:
            i += 1
            break
        if d == 2:
            out.append(data[i + 1])
            bound -= 1
            i += 2
            break

        hop = data[i + 2]
        out.append(data[i + 1])
        bound -= 1

        if b == hop and b == data[i + 1]:
            run = False
            # Run overlapping the previous pair: [i-1, i, i+1, i+2].
            if i > floor and b == data[i - 1]:
                if bound < 2:
                    i += 2
                    break
                out.append(hop)
                bound -= 1
                i += 3
                run = True
            # Fresh run [i, i+1, i+2, i+3].
            if not run and i + 3 < n:
                if b == data[i + 3]:
                    if bound == 0:
                        i += 2
                        break
                    out.append(hop)
                    bound -= 1
                    if bound < 2:
                        i += 3
                        break
                    out.append(data[i + 3])
                    bound -= 1
                    i += 4
                    run = True
            if run:
                rep = 0
                while rep < 251 and i < n and data[i] == b:
                    rep += 1
                    i += 1
                out.append(rep)
                bound -= 1
                floor = i
                if i >= n:
                    break
                b = data[i]
                continue

        i += 2
        b = hop

    return out, i


def _chunks(start, length):
    """(starts, lengths) of the chunks of runs ``[start, start + length)``."""
    q, r = np.divmod(length, 255)
    pieces = q + (r > 0)
    run = np.repeat(np.arange(len(start)), pieces)
    within = np.arange(int(pieces.sum())) - (np.cumsum(pieces) - pieces)[run]
    return start[run] + 255 * within, np.where(within < q[run], 255, r[run])


class Runs:
    """The maximal runs of 4 or more equal bytes of an input, and their
    chunks that the machine writes as 4 literals and a count."""

    def __init__(self, arr: np.ndarray):
        n = len(arr)
        starts = np.flatnonzero(np.diff(arr) != 0) + 1 if n else np.zeros(0, np.int64)
        starts = np.concatenate(([0], starts)).astype(np.int64) if n else starts
        lengths = np.diff(np.append(starts, n))
        big = lengths >= 4
        self.start, self.end = starts[big], (starts + lengths)[big]
        src, length = _chunks(self.start, self.end - self.start)
        self.src, self.len = src[length >= 4], length[length >= 4]

    def from_(self, offset: int, stop: int):
        """The chunks of a block that starts at ``offset``, up to ``stop``:
        a run that the last block cut is chunked again from ``offset``."""
        i = int(np.searchsorted(self.start, offset, side="right")) - 1
        src, length, after = np.zeros(0, np.int64), np.zeros(0, np.int64), offset
        if i >= 0 and self.start[i] < offset < self.end[i]:
            src, length = _chunks(np.array([offset]), np.array([self.end[i] - offset]))
            src, length, after = src[length >= 4], length[length >= 4], int(self.end[i])
        j0, j1 = np.searchsorted(self.src, [after, stop])
        src = np.concatenate((src, self.src[j0:j1]))
        length = np.concatenate((length, self.len[j0:j1]))
        beyond = int(self.src[j1]) if j1 < len(self.src) else None
        return src, length, beyond


def emit(arr: np.ndarray, lo: int, hi: int, src: np.ndarray, length: np.ndarray) -> np.ndarray:
    """RLE1 of ``arr[lo:hi]`` whose run chunks are ``(src, length)``."""
    seg = arr[lo:hi]
    if not len(src):
        return seg.copy()
    edge = np.zeros(hi - lo + 1, np.int64)
    edge[src + 4 - lo] += 1
    edge[src + length - lo] -= 1
    kept = seg[np.cumsum(edge)[:-1] == 0]
    extra = length - 4
    return np.insert(kept, src + 4 - lo - (np.cumsum(extra) - extra), extra.astype(np.uint8))


def next_block(arr: np.ndarray, data: bytes, runs: Runs, offset: int, cap: int):
    """(the RLE1 bytes of the block that starts at ``offset``, the input
    bytes it consumes)."""
    n = len(arr)
    stop = min(n, offset + MAX_IN_PER_OUT * cap)
    src, length, beyond = runs.from_(offset, stop)
    saved = np.cumsum(length - 5)
    if stop == n and n - offset - (int(saved[-1]) if len(saved) else 0) <= cap:
        return emit(arr, offset, n, src, length), n - offset
    # The last chunk that ends MARGIN before the bound is a loop top of the
    # machine, with nothing of the run before it to look back on.
    out_end = src + length - offset - saved
    ok = np.flatnonzero(out_end <= cap - MARGIN)
    k = int(ok[-1]) + 1 if len(ok) else 0
    top = int(src[k - 1] + length[k - 1]) if k else offset
    out = int(out_end[k - 1]) if k else 0
    # Literals up to 4 bytes before the next chunk are copied as they are,
    # two a loop, so the machine is at a loop top on the same parity.
    nxt = int(src[k]) if k < len(src) else (beyond if beyond is not None else n)
    skip = min(max(0, cap - MARGIN - out), max(0, nxt - 4 - top))
    skip -= skip & 1
    tail, end = machine_replay(data, top + skip, top, cap - out - skip)
    head = emit(arr, offset, top + skip, src[:k], length[:k])
    return np.concatenate((head, np.frombuffer(bytes(tail), np.uint8))), end - offset


@dataclass
class Rle1Block:
    output: np.ndarray   # uint8 RLE1 bytes, len <= block_capacity(level)
    consumed: int        # raw input bytes consumed by this block
    crc: int             # bzip2 block CRC over the consumed raw bytes


def iter_blocks(data, level: int, cap: int | None = None):
    """The RLE1 blocks of ``data`` at ``level`` (or of at most ``cap``
    output bytes), in order."""
    data = bytes(data)
    arr = np.frombuffer(data, np.uint8)
    cap = block_capacity(level) if cap is None else cap
    runs = Runs(arr)
    offset = 0
    while offset < len(arr):
        out, consumed = next_block(arr, data, runs, offset, cap)
        yield Rle1Block(out, consumed, block_crc(data[offset : offset + consumed]))
        offset += consumed
