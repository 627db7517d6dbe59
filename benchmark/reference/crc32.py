"""bzip2-flavored CRC-32 (MSB-first CRC-32/ISO-HDLC) plus the stream combiner.

Frozen copy of the host module of the same name in the port, for the
benchmark's plain reference: NumPy only, no C helpers, and nothing of
the program imported.

bzip2's block CRC uses the gzip polynomial 0x04C11DB7 but shifts MSB-first
with init/final-xor 0xFFFFFFFF (reference: lib/crc32.rs).  The MSB-first CRC
of a buffer equals the bit-reversal of the LSB-first (zlib) CRC of the
byte-wise bit-reversed buffer, which gives us a C-speed host path through
``zlib.crc32`` and ``bytes.translate``.
"""

from __future__ import annotations

import zlib

import numpy as np



def _bit_reverse_byte(b: int) -> int:
    b = ((b & 0xF0) >> 4) | ((b & 0x0F) << 4)
    b = ((b & 0xCC) >> 2) | ((b & 0x33) << 2)
    b = ((b & 0xAA) >> 1) | ((b & 0x55) << 1)
    return b


_REV8_TABLE = bytes(_bit_reverse_byte(i) for i in range(256))


def _bit_reverse_u32(x: int) -> int:
    x &= 0xFFFFFFFF
    return int(
        _REV8_TABLE[x & 0xFF] << 24
        | _REV8_TABLE[(x >> 8) & 0xFF] << 16
        | _REV8_TABLE[(x >> 16) & 0xFF] << 8
        | _REV8_TABLE[(x >> 24) & 0xFF]
    )


def block_crc(data: bytes | bytearray | memoryview | np.ndarray) -> int:
    """MSB-first CRC-32 of ``data`` — the per-block checksum (lib/rle.rs:244)."""
    if isinstance(data, np.ndarray):
        data = data.astype(np.uint8, copy=False).tobytes()
    reversed_bytes = bytes(data).translate(_REV8_TABLE)
    return _bit_reverse_u32(zlib.crc32(reversed_bytes))


def combine_stream_crc(stream_crc: int, blk_crc: int) -> int:
    """bzip2's rotate-left-then-XOR stream combine (lib/lib.rs:107-108).

    Order-dependent: blocks must be folded in input order, which is why the
    parallel pipeline gathers per-block CRCs and folds them on the host.
    """
    stream_crc &= 0xFFFFFFFF
    rot = ((stream_crc << 1) | (stream_crc >> 31)) & 0xFFFFFFFF
    return rot ^ (blk_crc & 0xFFFFFFFF)
