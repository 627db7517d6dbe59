"""Per-block compressed payloads, as the host writes them into the stream.

Counterpart of ``banzai_tpu/parallel/serial.py`` (``BlockPayload``), copied
because that package's ``__init__`` imports JAX.  A BlockPayload carries
everything needed to write one block: its CRC, BWT ptr, byte-presence map,
and the packed payload words with their bit length.  ``to_bytes`` and
``iter_from_bytes`` are the flat form in which payloads cross between the
processes of a multi-process encode (``parallel/multihost.py``): the same
bytes as ``banzai_tpu``'s, so a blob either package writes parses in the
other.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Iterator

import numpy as np

from .bitio import BitWriter
from .container import write_block_header, write_sym_map

_HDR = struct.Struct("<IIiI")   # crc, ptr, nbits, nwords


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

    def to_bytes(self) -> bytes:
        """Header (crc, ptr, nbits, nwords), the 32 packed presence bytes,
        then the ceil(nbits / 32) used words, little-endian."""
        tight = self.words[: (self.nbits + 31) // 32].astype("<u4")
        return (
            _HDR.pack(self.crc, self.ptr, self.nbits, len(tight))
            + np.packbits(self.present).tobytes()
            + tight.tobytes()
        )

    @classmethod
    def iter_from_bytes(cls, blob: bytes) -> Iterator[BlockPayload]:
        """The payloads of a concatenation of ``to_bytes`` blobs, in order."""
        off = 0
        while off < len(blob):
            crc, ptr, nbits, nwords = _HDR.unpack_from(blob, off)
            off += _HDR.size
            present = np.unpackbits(
                np.frombuffer(blob, np.uint8, 32, off)
            ).astype(bool)
            off += 32
            words = np.frombuffer(blob, "<u4", nwords, off)
            off += 4 * nwords
            yield cls(crc, ptr, present, words, nbits)
