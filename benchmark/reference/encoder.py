"""The plain reference encoder: level ``L`` bytes in, a .bz2 stream out.

The per-block pipeline of the port's host encoder (``encoder_host``):
RLE1 split and CRCs, BWT, MTF, RLE2, the entropy plan (the cheapest of a
single table, 2-6 refined tables and banzai's exact plan), emission.
Blocks are independent, so ``payloads`` may spread them over a process
pool; the stream is stitched in order here.
"""

from __future__ import annotations

import numpy as np

from .bitio import BitWriter
from .bwt import bwt
from .container import (
    write_block_header,
    write_stream_footer,
    write_stream_header,
    write_sym_map,
)
from .crc32 import combine_stream_crc
from .huffman_host import plan_entropy, write_entropy
from .mtf_rle2 import mtf_indices, rle2_encode
from .rle1 import iter_blocks

FULL_PLAN = ((2, 3, 4, 5, 6), True)   # (table counts, banzai candidate)


def block_payload(output: np.ndarray, plan=FULL_PLAN):
    """One RLE1 block -> (ptr, present bool [256], payload bytes, nbits).
    ``plan`` is (refined table counts, whether banzai's plan competes)."""
    column, ptr = bwt(output)
    present = np.zeros(256, dtype=bool)
    present[output] = True
    num_names = int(present.sum())
    syms, freqs = rle2_encode(mtf_indices(column, present), num_names)
    counts, banzai = plan
    chosen = plan_entropy(syms, num_names + 2, freqs, include_banzai=banzai,
                          table_counts=counts)
    bw = BitWriter()
    write_entropy(bw, syms, chosen)
    return ptr, present, bw.close(), bw.bit_length


def _payload_job(args):
    return block_payload(*args)


def compress_many(datas, level: int, pool=None, plan=FULL_PLAN) -> list[bytes]:
    """The stream of each input in ``datas``; with a ``multiprocessing``
    pool, the blocks of all inputs are encoded side by side."""
    blocks = [list(iter_blocks(d, level)) for d in datas]
    work = [(np.ascontiguousarray(b.output), plan)
            for bl in blocks for b in bl]
    done = (pool.imap(_payload_job, work) if pool is not None
            else map(_payload_job, work))
    streams = []
    for bl in blocks:
        bw = BitWriter()
        write_stream_header(bw, level)
        stream_crc = 0
        for blk in bl:
            ptr, present, raw, nbits = next(done)
            stream_crc = combine_stream_crc(stream_crc, blk.crc)
            write_block_header(bw, blk.crc, ptr)
            write_sym_map(bw, present)
            raw += b"\x00" * (-len(raw) % 4)
            bw.splice_words(np.frombuffer(raw, dtype=">u4"), nbits)
        write_stream_footer(bw, stream_crc)
        streams.append(bw.close())
    return streams


def compress(data: bytes, level: int = 9, plan=FULL_PLAN) -> bytes:
    """One stream, in this process."""
    return compress_many([data], level, plan=plan)[0]
