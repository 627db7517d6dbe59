"""Shared constants of the .bz2 container format and the encoder pipeline.

Frozen copy of the host module of the same name in the port, for the
benchmark's plain reference: NumPy only, no C helpers, and nothing of
the program imported.

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
