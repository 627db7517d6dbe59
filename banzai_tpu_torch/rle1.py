"""RLE1: bzip2's mandatory first-pass run-length encoding + block splitting.

Copy of ``banzai_tpu/rle1.py``, so the port imports nothing of the JAX
package; only the imports differ, and the output is byte for byte the
original's.

Reference behavior: lib/rle.rs:102-253 — a byte-serial state machine that
walks the input two bytes per iteration, collapses maximal runs of >=4 equal
bytes into ``4 literals + count`` (count <= 251, so a long run is consumed in
chunks of <=255 input bytes), and stops when the block's output bound
(``100_000*level - 1``) is exhausted, with intricate partial-emission rules
at the boundary.

TPU-first design: away from a block boundary the machine is *provably*
equivalent to a pure function of the maximal-run decomposition (each maximal
run of length L is consumed in chunks of min(255, remaining); a chunk c >= 4
emits 5 bytes, else c literal bytes).  We therefore:

1. detect only the *big* (>=4) runs with vectorized boolean algebra — small
   runs are literal pass-through and never materialized;
2. expand big runs into a single global table of chunk-emission events with
   exclusive prefix sums, so every block's output offsets are an affine
   function of one precomputed monotone key (O(log) per block, no window
   rebuilding);
3. replay the exact state machine only inside a ~600-byte window around
   each block boundary, starting from a provable "loop-top" checkpoint
   (the end of a run emission, where the machine state is fully known).

This reproduces the reference's block splits byte-exactly (differentially
tested against a full Python replay of the machine) at vectorized speed.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .constants import block_capacity
from .crc32 import block_crc

# Replay window: the machine can only diverge from the unbounded emission
# when the remaining bound is smaller than one iteration's max emission, but
# we keep a wide safety margin; replay cost is negligible per 100KB+ block.
_REPLAY_MARGIN = 600


# ---------------------------------------------------------------------------
# Exact state machine (oracle + boundary replay)
# ---------------------------------------------------------------------------

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


# ---------------------------------------------------------------------------
# Vectorized big-run detection and the global event table
# ---------------------------------------------------------------------------

def big_runs(arr: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(starts, lens) of all maximal runs of length >= 4, vectorized.

    Small runs are never materialized — crucial for run-dense inputs where
    the full run decomposition would dominate the encode.
    """
    n = len(arr)
    if n < 4:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    eq = arr[1:] == arr[:-1]                    # eq[i]: arr[i] == arr[i+1]
    e3 = eq[:-2] & eq[1:-1] & eq[2:]            # 4 equal bytes from i
    start_mask = e3.copy()
    start_mask[1:] &= ~eq[:-3]                  # maximal: previous differs
    starts = np.flatnonzero(start_mask).astype(np.int64)
    if len(starts) == 0:
        return starts, np.zeros(0, np.int64)
    if len(starts) <= 4096:
        # Sparse case: gallop from each start for its first break.
        ends = np.empty(len(starts), np.int64)
        for i, s in enumerate(starts):
            v = arr[s]
            e = s + 4
            step = 64
            while e < n and arr[e] == v:
                nxt = min(n, e + step)
                if np.all(arr[e:nxt] == v):
                    e = nxt
                    step *= 2
                else:
                    e += int(np.argmin(arr[e:nxt] == v))
                    break
            ends[i] = e
        return starts, ends - starts
    # Dense case: next inequality at/after each start via a reversed
    # running minimum over break positions (contiguous copy — accumulate
    # on a negative-stride view is an order of magnitude slower).
    # int32 positions fit inputs < 2 GiB; larger inputs need int64 (int32
    # would raise or silently wrap) at 2x the temp memory.
    pdt = np.int32 if n - 1 <= np.iinfo(np.int32).max else np.int64
    idx = np.arange(n - 1, dtype=pdt)
    nxt = np.where(eq, pdt(n - 1), idx)[::-1].copy()
    np.minimum.accumulate(nxt, out=nxt)
    ends = nxt[n - 2 - starts].astype(np.int64) + 1   # run end (exclusive)
    return starts, ends - starts


@dataclass
class EventTable:
    """Global chunk-emission events of all big runs, ascending by source.

    ``g = src_start - cum_in + cum_out`` is the monotone key that makes a
    block's relative output offset affine: for a block starting at
    ``offset`` with local prefix (in0, out0), event j's block-relative
    output start is ``g[j] + C`` with C constant per block.
    """

    src_start: np.ndarray   # input position where the chunk begins
    in_len: np.ndarray      # input bytes consumed (4..255, or <4 tail)
    out_len: np.ndarray     # output bytes emitted (5, or in_len if < 4)
    is_run: np.ndarray      # bool: emitted as "4 literals + count"
    value: np.ndarray       # the repeated byte
    cum_in: np.ndarray      # exclusive prefix sum of in_len
    cum_out: np.ndarray     # exclusive prefix sum of out_len
    g: np.ndarray           # src_start - cum_in + cum_out
    run_end: np.ndarray     # end of the maximal run this chunk belongs to


def _expand_chunks(
    starts: np.ndarray, lens: np.ndarray, data: np.ndarray
):
    q, r = np.divmod(lens, 255)
    npieces = q + (r > 0)
    total = int(npieces.sum())
    run_id = np.repeat(np.arange(len(starts)), npieces)
    excl = np.cumsum(npieces) - npieces
    within = np.arange(total, dtype=np.int64) - excl[run_id]
    chunk = np.where(within < q[run_id], 255, r[run_id]).astype(np.int64)
    src = starts[run_id] + within * 255
    is_run = chunk >= 4
    out_len = np.where(is_run, 5, chunk)
    value = (
        data[starts[run_id]] if total else np.zeros(0, np.uint8)
    )
    run_end = (starts + lens)[run_id] if total else np.zeros(0, np.int64)
    return src, chunk, out_len, is_run, value, run_end


def build_event_table(arr: np.ndarray) -> EventTable:
    starts, lens = big_runs(arr)
    src, chunk, out_len, is_run, value, run_end = _expand_chunks(
        starts, lens, arr
    )
    cum_in = np.cumsum(chunk) - chunk
    cum_out = np.cumsum(out_len) - out_len
    g = src - cum_in + cum_out
    return EventTable(
        src, chunk, out_len, is_run, value, cum_in, cum_out, g, run_end
    )


@dataclass
class _Events:
    """Per-block view: chunk events with block-relative output offsets."""

    src_start: np.ndarray
    in_len: np.ndarray
    out_len: np.ndarray
    is_run: np.ndarray
    value: np.ndarray
    out_start: np.ndarray

    def __len__(self) -> int:
        return len(self.src_start)


# ---------------------------------------------------------------------------
# Emission
# ---------------------------------------------------------------------------

def _emit_unbounded(
    ev: _Events, data: np.ndarray, block_offset: int, n_out: int, src_end: int
) -> np.ndarray:
    """Materialize the first ``n_out`` output bytes of the unbounded RLE1
    stream for the block starting at ``block_offset``.

    Only events fully inside the range are emitted; the caller guarantees
    ``n_out`` lands at an event boundary or inside a literal stretch
    (``src_end`` is the matching input position for the literal tail).
    """
    out = np.empty(n_out, dtype=np.uint8)
    k = int(np.searchsorted(ev.out_start + ev.out_len, n_out, side="right"))
    e_src = ev.src_start[:k]
    e_in = ev.in_len[:k]
    e_out = ev.out_len[:k]
    e_run = ev.is_run[:k]
    e_val = ev.value[:k]
    e_ostart = ev.out_start[:k]

    # Literal segments = gaps between events plus literal-chunk events
    # (big-run tails < 4 bytes); all copy input->output 1:1.
    gap_src = np.concatenate(([block_offset], e_src + e_in, e_src[~e_run]))
    gap_end = np.concatenate((e_src, [src_end], (e_src + e_in)[~e_run]))
    gap_out = np.concatenate(([0], e_ostart + e_out, e_ostart[~e_run]))
    gap_len = np.maximum(gap_end - gap_src, 0)
    total = int(gap_len.sum())
    if total and len(gap_len) <= 256:
        # Few gaps (typical for text blocks): direct slice copies beat the
        # index-array scatter by a wide margin.
        for gi in np.flatnonzero(gap_len):
            o, s, L = gap_out[gi], gap_src[gi], gap_len[gi]
            out[o : o + L] = data[s : s + L]
    elif total:
        excl = np.cumsum(gap_len) - gap_len
        seg = np.repeat(np.arange(len(gap_len)), gap_len)
        within = np.arange(total, dtype=np.int64) - excl[seg]
        out[np.repeat(gap_out, gap_len) + within] = (
            data[np.repeat(gap_src, gap_len) + within]
        )

    re = np.flatnonzero(e_run)
    if len(re):
        idx = e_ostart[re, None] + np.arange(4)[None, :]
        out[idx.ravel()] = np.repeat(e_val[re], 4)
        out[e_ostart[re] + 4] = (e_in[re] - 4).astype(np.uint8)
    return out


# ---------------------------------------------------------------------------
# Block splitting
# ---------------------------------------------------------------------------

@dataclass
class Rle1Block:
    output: np.ndarray   # uint8 RLE1 bytes, len <= block_capacity(level)
    consumed: int        # raw input bytes consumed by this block
    crc: int             # bzip2 block CRC over the consumed raw bytes


def iter_blocks(data, level: int, native: bool | None = None):
    """Lazily split ``data`` into RLE1-encoded blocks exactly as the
    reference does (lib/lib.rs:101-126 + lib/rle.rs).  Lazy so the host
    split of later blocks overlaps device encode of earlier ones.

    Prefers the native C machine (banzai_tpu_torch/native) when a toolchain is
    available; the NumPy event-table path is the portable fallback and the
    differential twin.
    """
    if isinstance(data, np.ndarray):
        arr = np.ascontiguousarray(data, dtype=np.uint8)
    else:
        try:
            # Zero-copy for bytes / memoryview / mmap buffers.
            arr = np.frombuffer(data, dtype=np.uint8)
        except (TypeError, ValueError):
            arr = np.frombuffer(bytes(data), dtype=np.uint8)
    n = len(arr)
    cap = block_capacity(level)
    # bytes input: reuse it (tobytes() would double peak RSS for nothing).
    data_bytes = data if isinstance(data, bytes) else arr.tobytes()

    if native is not False:
        from .native import get_rle1, rle1_block_native

        lib = get_rle1()
        if lib is not None:
            offset = 0
            while offset < n:
                out_b, consumed = rle1_block_native(
                    lib, data_bytes, offset, cap
                )
                crc = block_crc(data_bytes[offset : offset + consumed])
                yield Rle1Block(
                    np.frombuffer(out_b, dtype=np.uint8), consumed, crc
                )
                offset += consumed
            return
        if native:
            raise RuntimeError("native RLE1 requested but unavailable")

    et = build_event_table(arr)
    offset = 0
    while offset < n:
        out, consumed = _next_block(et, arr, data_bytes, offset, cap)
        crc = block_crc(data_bytes[offset : offset + consumed])
        yield Rle1Block(out, consumed, crc)
        offset += consumed


def split_blocks(data, level: int) -> list[Rle1Block]:
    """Eager form of :func:`iter_blocks`."""
    return list(iter_blocks(data, level))


def _local_chunks(offset: int, run_end: int):
    """Chunk events for the remainder of a run truncated at ``offset``."""
    src, inl, outl, isr = [], [], [], []
    pos = offset
    while run_end - pos > 0:
        c = min(255, run_end - pos)
        src.append(pos)
        inl.append(c)
        outl.append(5 if c >= 4 else c)
        isr.append(c >= 4)
        pos += c
    return src, inl, outl, isr


def _next_block(
    et: EventTable, arr: np.ndarray, data_bytes: bytes, offset: int, cap: int
) -> tuple[np.ndarray, int]:
    n = len(arr)
    ne = len(et.src_start)

    # --- local events: the (possibly) truncated run containing offset ----
    k = int(np.searchsorted(et.src_start, offset, side="right")) - 1
    loc_src: list = []
    loc_in: list = []
    loc_out: list = []
    loc_isr: list = []
    skip_until = offset
    if k >= 0 and et.src_start[k] + et.in_len[k] > offset:
        run_end = int(et.run_end[k])
        rest = run_end - offset
        if rest >= 4:
            loc_src, loc_in, loc_out, loc_isr = _local_chunks(
                offset, run_end
            )
        # rest < 4: plain literals, part of the gap.
        skip_until = run_end
    e0 = int(np.searchsorted(et.src_start, skip_until, side="left"))

    in_local = sum(loc_in)
    out_local = sum(loc_out)
    # Block-relative out_start of global event j >= e0: g[j] + C.
    if e0 < ne:
        C = (
            -offset
            - in_local
            + out_local
            + int(et.cum_in[e0])
            - int(et.cum_out[e0])
        )
    else:
        C = 0

    # --- does the rest of the input fit the cap? -------------------------
    if e0 < ne:
        tail_in = n - int(et.src_start[ne - 1] + et.in_len[ne - 1])
        last_out_end = int(et.g[ne - 1]) + C + int(et.out_len[ne - 1])
        total_out = last_out_end + tail_in
    else:
        # Everything outside local chunk events is literal 1:1.
        total_out = out_local + (n - offset - in_local)
    if total_out <= cap:
        ev = _slice_events(et, e0, ne, C, loc_src, loc_in, loc_out, loc_isr,
                           arr, offset)
        out = _emit_unbounded(ev, arr, offset, total_out, n)
        return out, n - offset

    # --- find the cap crossing and a checkpoint --------------------------
    target = cap - _REPLAY_MARGIN
    # Last global event with out_end <= target: g[j] + C + out_len[j] <= target
    # out_len <= 5 so search on g then refine linearly a few steps.
    j1 = int(np.searchsorted(et.g[e0:], target - C + 1, side="left")) + e0
    j1 = min(j1 + 4, ne)
    ev = _slice_events(et, e0, j1, C, loc_src, loc_in, loc_out, loc_isr,
                       arr, offset)

    ev_out_end = ev.out_start + ev.out_len
    ev_src_end = ev.src_start + ev.in_len
    run_ev = np.flatnonzero(ev.is_run & (ev_out_end <= target))
    if len(run_ev):
        j = int(run_ev[-1])
        cp_i = int(ev_src_end[j])
        cp_floor = cp_i
        cp_out = int(ev_out_end[j])
        next_j = j + 1
    else:
        cp_i = offset
        cp_floor = offset  # blocks path-A lookback across the block start
        cp_out = 0
        next_j = 0
    # Fast-forward the checkpoint through pure-literal territory.  Literal
    # chunk events (big-run tails < 4 bytes) copy input->output 1:1 exactly
    # like the gaps between events, so only the next RUN event is a
    # barrier — stopping at a literal event would leave machine_replay to
    # walk the rest of the block byte-serially in Python (~10-30x slower
    # on run-then-literal blocks).  Events beyond the j1 view are treated
    # as barriers too (their kind is unknown here).
    nxt_run = np.flatnonzero(ev.is_run[next_j:])
    if len(nxt_run):
        s_next = int(ev.src_start[next_j + int(nxt_run[0])])
    elif j1 < ne:
        s_next = int(et.src_start[j1])
    else:
        s_next = n
    avail = max(0, target - cp_out)
    lit_span = max(0, (s_next - 4) - cp_i)
    adv = min(avail, lit_span)
    adv -= adv & 1
    if adv > 0:
        cp_i += adv
        cp_out += adv

    tail, final_i = machine_replay(data_bytes, cp_i, cp_floor, cap - cp_out)
    head = _emit_unbounded(ev, arr, offset, cp_out, cp_i)
    out = np.concatenate((head, np.frombuffer(bytes(tail), dtype=np.uint8)))
    return out, final_i - offset


def _slice_events(
    et: EventTable, e0: int, e1: int, C: int,
    loc_src, loc_in, loc_out, loc_isr, arr: np.ndarray, offset: int,
) -> _Events:
    """Assemble the block's event view: local truncated-run chunks followed
    by global events [e0, e1) with out_start = g + C."""
    nl = len(loc_src)
    src = np.concatenate(
        (np.asarray(loc_src, np.int64), et.src_start[e0:e1])
    )
    inl = np.concatenate((np.asarray(loc_in, np.int64), et.in_len[e0:e1]))
    outl = np.concatenate((np.asarray(loc_out, np.int64), et.out_len[e0:e1]))
    isr = np.concatenate(
        (np.asarray(loc_isr, bool), et.is_run[e0:e1])
    )
    val = np.concatenate(
        (
            arr[np.asarray(loc_src, np.int64)]
            if nl
            else np.zeros(0, np.uint8),
            et.value[e0:e1],
        )
    )
    # Local out_starts: literals between offset..first local chunk are 1:1.
    if nl:
        lo = np.cumsum(np.asarray(loc_out, np.int64)) - np.asarray(
            loc_out, np.int64
        )
        loc_ostart = (np.asarray(loc_src, np.int64) - offset) - (
            np.cumsum(np.asarray(loc_in, np.int64))
            - np.asarray(loc_in, np.int64)
        ) + lo
    else:
        loc_ostart = np.zeros(0, np.int64)
    out_start = np.concatenate((loc_ostart, et.g[e0:e1] + C))
    return _Events(src, inl, outl, isr, val, out_start)


def machine_split_blocks(data, level: int) -> list[Rle1Block]:
    """Oracle: split blocks with the byte-serial machine only (slow)."""
    data_bytes = bytes(data)
    n = len(data_bytes)
    cap = block_capacity(level)
    blocks = []
    offset = 0
    while offset < n:
        out, final_i = machine_replay(data_bytes, offset, offset, cap)
        consumed = final_i - offset
        crc = block_crc(data_bytes[offset:final_i])
        blocks.append(
            Rle1Block(np.frombuffer(bytes(out), dtype=np.uint8), consumed, crc)
        )
        offset = final_i
    return blocks
