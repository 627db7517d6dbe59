"""Per-block compressed payloads, as the host writes them into the stream.

Counterpart of ``banzai_tpu/parallel/serial.py`` (``BlockPayload``), copied
because that package's ``__init__`` imports JAX.  A BlockPayload carries
everything needed to write one block: its CRC, BWT ptr, byte-presence map,
and the packed payload words with their bit length.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .bitio import BitWriter
from .container import write_block_header, write_sym_map


@dataclass
class BlockPayload:
    crc: int
    ptr: int
    present: np.ndarray        # bool[256]
    words: np.ndarray          # uint32[>= ceil(nbits / 32)]
    nbits: int

    def write(self, bw: BitWriter) -> None:
        write_block_header(bw, self.crc, self.ptr)
        write_sym_map(bw, self.present)
        bw.splice_words(self.words, self.nbits)
