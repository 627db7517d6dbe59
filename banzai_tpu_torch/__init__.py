"""banzai_tpu_torch — the banzai_tpu bzip2 encoder in PyTorch and CUDA.

The per-block pipeline (BWT -> MTF -> RLE2 -> entropy plan -> bit packing)
runs as batched PyTorch tensor code on one CUDA device, with hand-written
CUDA kernels (``csrc/``) for the MTF shuffle, the RLE2 expansion and the
word assembly.  Host RLE1, staging, the device and the drain overlap on
threads of their own (``pipeline.compress_blocks_iter``).  The host side
(RLE1 block splitting, CRCs, container framing, the host encoder for tiny
blocks) is reused from ``banzai_tpu``'s JAX-free modules.  Output is
byte-identical to ``banzai_tpu.encoder_host.compress``.

Public API:

* ``compress(data, level=9, device="cuda") -> bytes``
* ``encode(reader, writer, level=9, device="cuda") -> int``
* ``encode_file(input_path, output_path, level=9, device="cuda")``

``device`` is explicit: ``"cuda"`` without a CUDA device raises, and
``"cpu"`` runs the kernels' plain PyTorch versions.
"""

from __future__ import annotations

from typing import BinaryIO

from .pipeline import EncodeStats, compress as _compress

__version__ = "0.1.0"

__all__ = ["EncodeStats", "compress", "encode", "encode_file"]


def _check_level(level: int) -> None:
    if not 1 <= level <= 9:
        raise ValueError(f"level must be in 1..9, got {level}")


def compress(
    data: bytes,
    level: int = 9,
    device: str = "cuda",
    stats: EncodeStats | None = None,
    *,
    batch: int | None = None,
    hybrid_jobs: int | None = None,
) -> bytes:
    """One-shot encode of ``data`` at ``level`` (block size level*100kB)
    on ``device``.  ``stats``, when given, receives the block route counts
    and host timings (and the stage times, if its ``stage_ms`` is a dict).
    ``batch`` and ``hybrid_jobs`` are as in
    ``pipeline.compress_blocks_iter``."""
    _check_level(level)
    return _compress(data, level, device, stats, batch=batch,
                     hybrid_jobs=hybrid_jobs)


def encode(
    reader: BinaryIO,
    writer: BinaryIO,
    level: int = 9,
    device: str = "cuda",
    span_bytes: int = 32 * 1024 * 1024,
    report=None,
) -> int:
    """Stream-encode ``reader`` into ``writer`` with bounded memory;
    returns the number of bytes written.

    Input is read in ``span_bytes`` spans.  Every block of a span but the
    last, which the next span could still grow, goes to the device
    pipeline as soon as the span is split; the stream CRC and the raw
    tail are all that is carried from span to span.  Each finished block
    is written out at once.  When ``report`` (a
    ``banzai_tpu.profiling.EncodeReport``) is given, per-block stats are
    appended to it as blocks are written.  The device is resolved before
    anything is read or written."""
    from banzai_tpu.bitio import BitWriter
    from banzai_tpu.container import write_stream_footer, write_stream_header
    from banzai_tpu.crc32 import combine_stream_crc
    from banzai_tpu.rle1 import split_blocks

    from ._device import resolve_device
    from .pipeline import compress_blocks_iter

    _check_level(level)
    dev = resolve_device(device)
    bw = BitWriter()
    write_stream_header(bw, level)
    stream_crc = 0
    written = 0

    def flush(final: bool = False) -> None:
        nonlocal written
        chunk = bw.drain(final=final)
        if chunk:
            writer.write(chunk)
            written += len(chunk)

    def span_blocks():
        """Lazy block stream across spans: the pipeline's producer thread
        pulls it, so the next span is read and split while the device
        works on the current one."""
        tail = b""
        eof = False
        while not eof:
            buf = reader.read(span_bytes)
            eof = not buf
            data = tail + buf
            if not data:
                return
            blocks = split_blocks(data, level)
            if not eof:
                blocks = blocks[:-1]        # the last block may still grow
            consumed = 0
            for blk in blocks:
                consumed += blk.consumed
                yield blk
            tail = data[consumed:]

    for blk, p in compress_blocks_iter(span_blocks(), level, dev):
        stream_crc = combine_stream_crc(stream_crc, p.crc)
        p.write(bw)
        if report is not None:
            report.add_block(
                blk.consumed, len(blk.output), p.nbits, p.ptr, p.crc,
            )
        flush()
    write_stream_footer(bw, stream_crc)
    flush(final=True)
    return written


def encode_file(
    input_path: str, output_path: str, level: int = 9, device: str = "cuda"
) -> None:
    """File-to-file encode (level 9 by default, as the reference's)."""
    with open(input_path, "rb") as fin, open(output_path, "wb") as fout:
        encode(fin, fout, level, device)
