"""Shared constants of the .bz2 container format and the encoder pipeline.

Copy of ``banzai_tpu/constants.py``, so the port imports nothing of the JAX
package; only the imports differ, and the output is byte for byte the
original's.

Format constants mirror the reference encoder's container layout
(reference: lib/lib.rs:18-80, lib/huffman.rs:13, lib/mtf.rs:29-31) and the
bzip2 stream specification.  They are restated here from the spec; nothing
is derived from reference code structure.
"""

# --- Stream container ------------------------------------------------------
STREAM_MAGIC = b"BZh"                     # lib/lib.rs:18-22
BLOCK_MAGIC = 0x314159265359              # 48-bit block header magic (lib/lib.rs:24)
STREAM_FOOTER_MAGIC = 0x177245385090      # 48-bit footer magic (lib/lib.rs:66)

# --- Block sizing ----------------------------------------------------------
BLOCK_UNIT = 100_000                      # bytes per level (lib/lib.rs:74-75)
MIN_LEVEL = 1
MAX_LEVEL = 9


def block_capacity(level: int) -> int:
    """Maximum RLE1 bytes a block may hold: one byte is reserved so the MTF
    EOB symbol always fits bzip2's hard block limit (lib/rle.rs:120-122)."""
    return BLOCK_UNIT * level - 1


# Symbol space (lib/mtf.rs:29-31): RUNA=0, RUNB=1, then 255 shifted MTF
# indices and EOB — 258 symbols max; documented where used (ops/rle2.py,
# mtf_rle2.py, ops/huffman.py).

# --- Huffman stage ---------------------------------------------------------
CODEWORD_MAX_LEN = 17                     # encoder-side cap (lib/huffman.rs:13);
                                          # decoders accept up to 20
SEGMENT_WIDTH = 50                        # selector granularity (lib/huffman.rs:310)

# --- CRC -------------------------------------------------------------------
CRC32_POLY = 0x04C11DB7                   # MSB-first gzip polynomial (lib/crc32.rs)

# --- Symbol/table shape constants (shared by ops/huffman.py, ops/bitpack.py)
MAX_SYMS = 258                            # RUNA/RUNB + 255 MTF + EOB, padded
MAX_TABLES = 6                            # bzip2 table cap (lib/huffman.rs:13)
