"""banzai_tpu_torch — the banzai_tpu bzip2 encoder in PyTorch and CUDA.

The per-block pipeline (BWT -> MTF -> RLE2 -> entropy plan -> bit packing)
runs as batched PyTorch tensor code on CUDA devices, with hand-written
CUDA kernels (``csrc/``) for the MTF shuffle, the RLE2 expansion and the
word assembly.  Host RLE1, staging, the device and the drain overlap on
threads of their own (``pipeline.compress_blocks_iter``).  The host side
(RLE1 block splitting, CRCs, container framing, the host encoder for tiny
blocks) lives in this package too, as copies of ``banzai_tpu``'s host
modules: the port imports nothing of the JAX package.  Output is
byte-identical to the host encoder ``encoder_host.compress``.

Importing the package imports no torch: ``pipeline`` is loaded by the
first encode (or the first use of ``EncodeStats``), so spawned host
workers, which unpickle ``encoder_host`` functions, stay torch-free.

Public API:

* ``compress(data, level=9, device="cuda", stats=None) -> bytes``
* ``encode(reader, writer, level=9, device="cuda", stats=None) -> int``
* ``encode_file(input_path, output_path, level=9, device="cuda")``

``device`` is explicit: ``"cuda"`` without a CUDA device raises, and
``"cpu"`` runs the kernels' plain PyTorch versions.  ``"cuda"`` is the
current card; a sequence such as ``["cuda:0", "cuda:1"]`` names the
devices, one device thread each (``parallel.dp.block_devices``).
``parallel.multihost`` spreads an encode over the processes of a
``torch.distributed`` group.
"""

from __future__ import annotations

from collections.abc import Sequence
from typing import TYPE_CHECKING, BinaryIO

if TYPE_CHECKING:
    from .pipeline import EncodeStats

__version__ = "0.1.0"

__all__ = ["EncodeStats", "compress", "encode", "encode_file"]


def __getattr__(name: str):
    if name == "EncodeStats":
        from .pipeline import EncodeStats

        return EncodeStats
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _check_level(level: int) -> None:
    if not 1 <= level <= 9:
        raise ValueError(f"level must be in 1..9, got {level}")


def compress(
    data: bytes,
    level: int = 9,
    device: str | Sequence[str] = "cuda",
    stats: EncodeStats | None = None,
    *,
    batch: int | None = None,
    hybrid_jobs: int | None = None,
) -> bytes:
    """One-shot encode of ``data`` at ``level`` (block size level*100kB)
    on ``device``.  ``stats`` (a ``pipeline.EncodeStats``), when given,
    receives the block route counts, the host and device timings, and the
    synchronised stage times if its ``stage_ms`` is a dict.
    ``batch`` and ``hybrid_jobs`` are as in
    ``pipeline.compress_blocks_iter``."""
    from .pipeline import compress as _compress

    _check_level(level)
    return _compress(data, level, device, stats, batch=batch,
                     hybrid_jobs=hybrid_jobs)


def encode(
    reader: BinaryIO,
    writer: BinaryIO,
    level: int = 9,
    device: str | Sequence[str] = "cuda",
    span_bytes: int = 32 * 1024 * 1024,
    report=None,
    stats: EncodeStats | None = None,
) -> int:
    """Stream-encode ``reader`` into ``writer`` with bounded memory;
    returns the number of bytes written.

    Input is read in ``span_bytes`` spans.  Every block of a span but the
    last, which the next span could still grow, goes to the device
    pipeline as soon as the span is split; the stream CRC and the raw
    tail are all that is carried from span to span.  Each finished block
    is written out at once.  When ``report`` (a
    ``profiling.EncodeReport``) is given, per-block stats are
    appended to it as blocks are written.  ``device`` and ``stats`` are
    as in ``compress``; the devices are resolved before anything is read
    or written."""
    from .bitio import BitWriter
    from .container import write_stream_footer, write_stream_header
    from .crc32 import combine_stream_crc
    from .parallel.dp import block_devices
    from .pipeline import compress_blocks_iter
    from .rle1 import split_blocks

    _check_level(level)
    devs = block_devices(device)
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

    for blk, p in compress_blocks_iter(span_blocks(), level, devs,
                                       stats=stats):
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
    input_path: str,
    output_path: str,
    level: int = 9,
    device: str | Sequence[str] = "cuda",
) -> None:
    """File-to-file encode (level 9 by default, as the reference's)."""
    with open(input_path, "rb") as fin, open(output_path, "wb") as fout:
        encode(fin, fout, level, device)
