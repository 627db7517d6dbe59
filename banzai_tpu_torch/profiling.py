"""Per-block statistics for the CLI's ``--verbose`` report.

Copy of ``BlockStats`` and ``EncodeReport`` from
``banzai_tpu/profiling.py``, so the port imports nothing of the JAX
package; the report's text is the original's.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class BlockStats:
    index: int
    consumed: int          # raw input bytes in this block
    rle1_len: int          # post-RLE1 bytes
    payload_bits: int      # entropy payload bits (excl. header/symmap)
    ptr: int
    crc: int

    @property
    def ratio(self) -> float:
        return (self.payload_bits / 8) / max(1, self.consumed)


@dataclass
class EncodeReport:
    level: int
    blocks: list[BlockStats] = field(default_factory=list)
    stage_seconds: dict = field(default_factory=dict)

    def add_block(
        self, consumed: int, rle1_len: int, payload_bits: int,
        ptr: int, crc: int,
    ) -> None:
        self.blocks.append(
            BlockStats(
                len(self.blocks), consumed, rle1_len, payload_bits, ptr, crc
            )
        )

    def summary(self) -> str:
        total_in = sum(b.consumed for b in self.blocks)
        total_bits = sum(b.payload_bits for b in self.blocks)
        lines = [
            f"level {self.level}: {len(self.blocks)} blocks, "
            f"{total_in} bytes in, ~{total_bits // 8} payload bytes"
        ]
        for b in self.blocks:
            lines.append(
                f"  block {b.index}: raw {b.consumed} -> rle1 {b.rle1_len} "
                f"-> {b.payload_bits} bits (ratio {b.ratio:.3f}) "
                f"ptr {b.ptr}"
            )
        for k, v in self.stage_seconds.items():
            lines.append(f"  [{k}] {v * 1000:.1f} ms")
        return "\n".join(lines)
