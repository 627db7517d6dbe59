"""bzip2-flavored CRC-32 (MSB-first CRC-32/ISO-HDLC) plus the stream combiner.

Copy of ``banzai_tpu/crc32.py``, so the port imports nothing of the JAX
package; only the imports differ, and the output is byte for byte the
original's.

bzip2's block CRC uses the gzip polynomial 0x04C11DB7 but shifts MSB-first
with init/final-xor 0xFFFFFFFF (reference: lib/crc32.rs).  The MSB-first CRC
of a buffer equals the bit-reversal of the LSB-first (zlib) CRC of the
byte-wise bit-reversed buffer, which gives us a C-speed host path through
``zlib.crc32`` and ``bytes.translate``.

The slow table-driven form is kept as an independent oracle for tests.
"""

from __future__ import annotations

import zlib

import numpy as np

from .constants import CRC32_POLY


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


# --- Independent slow oracle ----------------------------------------------

def _build_msb_table() -> list[int]:
    table = []
    for i in range(256):
        reg = i << 24
        for _ in range(8):
            if reg & 0x80000000:
                reg = ((reg << 1) ^ CRC32_POLY) & 0xFFFFFFFF
            else:
                reg = (reg << 1) & 0xFFFFFFFF
        table.append(reg)
    return table


_MSB_TABLE = _build_msb_table()


def block_crc_slow(data: bytes) -> int:
    """Direct MSB-first table CRC; oracle for :func:`block_crc`."""
    reg = 0xFFFFFFFF
    for b in data:
        reg = ((reg << 8) & 0xFFFFFFFF) ^ _MSB_TABLE[((reg >> 24) ^ b) & 0xFF]
    return reg ^ 0xFFFFFFFF


def combine_stream_crc(stream_crc: int, blk_crc: int) -> int:
    """bzip2's rotate-left-then-XOR stream combine (lib/lib.rs:107-108).

    Order-dependent: blocks must be folded in input order, which is why the
    parallel pipeline gathers per-block CRCs and folds them on the host.
    """
    stream_crc &= 0xFFFFFFFF
    rot = ((stream_crc << 1) | (stream_crc >> 31)) & 0xFFFFFFFF
    return rot ^ (blk_crc & 0xFFFFFFFF)
