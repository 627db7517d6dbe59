""".bz2 container framing: stream header/footer, block headers, symbol maps.

Frozen copy of the host module of the same name in the port, for the
benchmark's plain reference: NumPy only, no C helpers, and nothing of
the program imported.

Layout per the bzip2 stream format (reference: lib/lib.rs:18-80).  These are
tiny host-side writes; all bulk payload bits are spliced in as packed words
(see bitio.BitWriter.splice_words).
"""

from __future__ import annotations

import numpy as np

from .bitio import BitWriter
from .constants import (
    BLOCK_MAGIC,
    MAX_LEVEL,
    MIN_LEVEL,
    STREAM_FOOTER_MAGIC,
    STREAM_MAGIC,
)


def write_stream_header(bw: BitWriter, level: int) -> None:
    """``"BZh" + ascii(level)`` (lib/lib.rs:18-22)."""
    assert MIN_LEVEL <= level <= MAX_LEVEL
    bw.write_bytes(STREAM_MAGIC + bytes([ord("0") + level]))


def write_block_header(bw: BitWriter, crc: int, ptr: int) -> None:
    """48-bit magic, 32-bit CRC, 1-bit randomized=0, 24-bit BWT ptr
    (lib/lib.rs:24-36)."""
    bw.write_bits(BLOCK_MAGIC >> 24, 24)
    bw.write_bits(BLOCK_MAGIC & 0xFFFFFF, 24)
    bw.write_bits(crc, 32)
    bw.write_bits(0, 1)
    bw.write_bits(ptr, 24)


def write_sym_map(bw: BitWriter, present: np.ndarray) -> None:
    """16-bit sector bitmap + one 16-bit bitmap per non-empty sector
    (lib/lib.rs:39-64).  ``present``: bool[256]."""
    present = np.asarray(present, dtype=bool).reshape(16, 16)
    sectors = present.any(axis=1)
    sector_bits = 0
    for a in range(16):
        sector_bits = (sector_bits << 1) | int(sectors[a])
    bw.write_bits(sector_bits, 16)
    for a in range(16):
        if sectors[a]:
            bits = 0
            for b in range(16):
                bits = (bits << 1) | int(present[a, b])
            bw.write_bits(bits, 16)


def write_stream_footer(bw: BitWriter, stream_crc: int) -> None:
    """48-bit footer magic + combined stream CRC (lib/lib.rs:66-70)."""
    bw.write_bits(STREAM_FOOTER_MAGIC >> 24, 24)
    bw.write_bits(STREAM_FOOTER_MAGIC & 0xFFFFFF, 24)
    bw.write_bits(stream_crc, 32)
