"""Per-block statistics and the per-block encode report.

Copy of ``banzai_tpu/profiling.py``, so the port imports nothing of the
JAX package; the report's text is the original's.  ``encode_report``'s
``backend="device"`` is the original's ``"jax"``: the port's device
pipeline on ``device``.
"""

from __future__ import annotations

import time
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


def encode_report(
    data: bytes, level: int = 9, backend: str = "numpy", device="cuda",
) -> EncodeReport:
    """Encode ``data`` collecting per-block stats: with the host encoder
    (``backend="numpy"``) or the device pipeline on ``device``
    (``backend="device"``)."""
    from .rle1 import split_blocks

    if backend not in ("numpy", "device"):
        raise ValueError(f"backend must be 'numpy' or 'device', got "
                         f"{backend!r}")
    report = EncodeReport(level=level)
    t0 = time.perf_counter()
    blocks = split_blocks(data, level)
    report.stage_seconds["rle1+split"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    if backend == "device":
        from .pipeline import compress_blocks_payloads

        payloads = compress_blocks_payloads(data, level, device)
        for i, (blk, p) in enumerate(zip(blocks, payloads, strict=True)):
            report.blocks.append(
                BlockStats(i, blk.consumed, len(blk.output), p.nbits,
                           p.ptr, p.crc)
            )
    else:
        from .bitio import BitWriter
        from .encoder_host import encode_block

        for i, blk in enumerate(blocks):
            bw = BitWriter()
            ptr, payload_bits = encode_block(bw, blk.output, blk.crc)
            # Same numbers as the device path (BlockStats contract:
            # entropy payload bits, real ptr).
            report.blocks.append(
                BlockStats(i, blk.consumed, len(blk.output),
                           payload_bits, ptr, blk.crc)
            )
    report.stage_seconds["encode"] = time.perf_counter() - t0
    return report

