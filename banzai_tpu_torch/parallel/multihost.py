"""Multi-process encode over ``torch.distributed``.

Counterpart of ``banzai_tpu/parallel/multihost.py``, with the JAX job
(``jax.distributed``) replaced by a ``torch.distributed`` process group
that the caller initialises, one rank per process.  Everything that moves
between ranks is host bytes on CPU tensors: span rows, payload blobs and
float64 stats, so the group's backend must carry CPU tensors (``gloo``,
or a mixed ``"cpu:gloo,cuda:nccl"``).  It needs no card per rank: several
ranks may share one card.

* Every rank owns a contiguous *span* of the input (spans, not striding,
  so RLE1's sequential block splitting stays rank-local).
* Rank 0 plans, every rank encodes, pipelined.  Block boundaries depend
  on every preceding byte, so rank 0 streams the input through the RLE1
  splitter.  The scan is incremental: as soon as span ``h``'s boundary is
  found it is broadcast as an [offset, length] row, and rank ``h`` starts
  encoding on a worker thread while later spans are still being planned.
  The last span is the remainder and needs no scan.
* The path entry point reads the input from a file every rank can read;
  each rank reads only its own span.
* Each rank encodes its span with ``pipeline.compress_blocks_payloads`` on
  its own devices (``device``, as ``parallel.dp.block_devices`` resolves
  it).  ``"cuda"`` is the process's current card, so one process per card
  names its card, ``"cuda:<local rank>"``, or sets it first with
  ``torch.cuda.set_device``.
* The payloads (``serial.BlockPayload.to_bytes``) are gathered to rank 0
  in ``_GATHER_CHUNK`` rounds and stitched in input order; the stream CRC
  combine is the only order-dependent state.
* Every collective runs on the calling thread: a group must not run two
  collectives at once from two threads.  The encode runs beside them.
* ``report`` (every rank) receives the span waits, encode walls, the
  planner's scan time, the gathered payload bytes and the modeled
  efficiency ``sum(encode_r) / (nproc * max_r(wall_r))``, ``wall_r`` being
  rank r's measured wall (span wait + encode + gather); the keys are the
  JAX package's.

A rank whose encode fails raises; the others fail in their next
collective once its process has exited (or at the group's timeout).
"""

from __future__ import annotations

import mmap
import os
import threading
import time
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ..crc32 import combine_stream_crc
from ..rle1 import iter_blocks
from .dp import Devices, block_devices

_GATHER_CHUNK = 8 << 20  # bytes per gather round


@dataclass
class Span:
    offset: int
    length: int


def plan_spans(data, level: int, n_hosts: int) -> list[Span]:
    """Split ``data`` into per-rank spans on exact RLE1 block boundaries.

    Single-shot form of the incremental rule the pipelined planner uses
    (proportional bytes, each span rounded up to the block boundary that
    reaches its share; the last span is the unscanned remainder)."""
    total = len(data)
    blocks = iter_blocks(data, level)
    spans = []
    off = 0
    for h in range(n_hosts):
        remaining = total - off
        if h == n_hosts - 1:
            length = remaining
        else:
            target = -(-remaining // (n_hosts - h))
            length = 0
            while length < target:
                blk = next(blocks, None)
                if blk is None:
                    break
                length += blk.consumed
        spans.append(Span(off, length))
        off += length
    return spans


def world() -> tuple[int, int]:
    """(world size, rank) of the default process group; (1, 0) when none
    is initialised."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _all_gather(t: torch.Tensor, nproc: int) -> torch.Tensor:
    out = [torch.empty_like(t) for _ in range(nproc)]
    dist.all_gather(out, t)
    return torch.stack(out)


def _gather_chunked(flat: bytes, nproc: int, pid: int) -> list[bytes] | None:
    """Gather every rank's byte blob to rank 0 in bounded chunks.

    Rank 0 returns the blobs in rank order, the others None.  Peak extra
    memory per round is nproc * _GATHER_CHUNK, not nproc * the largest
    blob."""
    lengths = _all_gather(torch.tensor([len(flat)], dtype=torch.int64),
                          nproc).reshape(-1).tolist()
    maxlen = max(lengths)
    parts: list[list[bytes]] = [[] for _ in range(nproc)]
    src = np.frombuffer(flat, np.uint8)
    for lo in range(0, maxlen, _GATHER_CHUNK):
        hi = min(lo + _GATHER_CHUNK, maxlen)
        buf = np.zeros(hi - lo, np.uint8)
        take = src[lo : min(hi, len(src))]
        buf[: len(take)] = take
        if pid == 0:
            got = [torch.empty(hi - lo, dtype=torch.uint8)
                   for _ in range(nproc)]
            dist.gather(torch.from_numpy(buf), got, dst=0)
            for h in range(nproc):
                parts[h].append(got[h].numpy().tobytes())
        else:
            dist.gather(torch.from_numpy(buf), dst=0)
    if pid != 0:
        return None
    return [b"".join(parts[h])[: lengths[h]] for h in range(nproc)]


def _stitch(blobs: list[bytes], level: int) -> bytes:
    from ..bitio import BitWriter
    from ..container import write_stream_footer, write_stream_header
    from .serial import BlockPayload

    bw = BitWriter()
    write_stream_header(bw, level)
    stream_crc = 0
    for blob in blobs:
        for p in BlockPayload.iter_from_bytes(blob):
            stream_crc = combine_stream_crc(stream_crc, p.crc)
            p.write(bw)
    write_stream_footer(bw, stream_crc)
    return bw.close()


def _encode_pipelined(
    read_span,
    consumed_iter,
    total: int,
    level: int,
    nproc: int,
    pid: int,
    report: dict | None,
    device: Devices,
) -> bytes:
    """The pipelined core: incremental span broadcast + threaded encode.

    ``read_span(Span) -> bytes`` fetches this rank's input bytes;
    ``consumed_iter`` (rank 0 only) yields per-block consumed counts from
    the streaming splitter.  Returns the stitched stream on rank 0, b""
    elsewhere, and fills ``report`` on every rank."""
    from ..pipeline import compress_blocks_payloads

    t_entry = time.perf_counter()
    enc_out: dict = {}
    enc_thread = None
    span_wait = 0.0
    off = 0
    scan_s = 0.0

    def run(data: bytes) -> None:
        try:
            t0 = time.perf_counter()
            ps = compress_blocks_payloads(data, level, device)
            enc_out["flat"] = b"".join(p.to_bytes() for p in ps)
            enc_out["encode_s"] = time.perf_counter() - t0
        except BaseException as e:     # re-raised on the calling thread
            enc_out["error"] = e

    try:
        for h in range(nproc):
            if pid == 0:
                remaining = total - off
                if h == nproc - 1:
                    length = remaining        # remainder: no scan needed
                else:
                    target = -(-remaining // (nproc - h))
                    length = 0
                    t0 = time.perf_counter()
                    while length < target:
                        c = next(consumed_iter, None)
                        if c is None:
                            break
                        length += c
                    scan_s += time.perf_counter() - t0
                row = torch.tensor([off, length], dtype=torch.int64)
                off += length
            else:
                row = torch.zeros(2, dtype=torch.int64)
            dist.broadcast(row, src=0)
            if h == pid:
                span = Span(int(row[0]), int(row[1]))
                span_wait = time.perf_counter() - t_entry
                # Encode on a worker thread, so this rank keeps serving the
                # remaining span broadcasts.
                enc_thread = threading.Thread(
                    target=run, args=(read_span(span),),
                    name=f"banzai_tpu_torch-span{pid}",
                )
                enc_thread.start()
    finally:
        if enc_thread is not None:
            enc_thread.join()
    if "error" in enc_out:
        raise enc_out["error"]
    flat = enc_out["flat"]
    t0 = time.perf_counter()
    blobs = _gather_chunked(flat, nproc, pid)
    # The gather also waits for ranks still encoding (it cannot complete
    # before the slowest rank arrives), so it is not pure transfer time;
    # the efficiency model uses the measured walls instead.
    gather_s = time.perf_counter() - t0
    wall_s = time.perf_counter() - t_entry

    stats = _all_gather(
        torch.tensor([span_wait, enc_out["encode_s"], float(len(flat)),
                      wall_s], dtype=torch.float64),
        nproc,
    ).numpy()
    if report is not None:
        waits, encs, payload = stats[:, 0], stats[:, 1], stats[:, 2]
        t1 = float(encs.sum())               # modeled single-rank encode
        tn = float(stats[:, 3].max())        # measured parallel wall
        report.update(
            nproc=nproc,
            input_bytes=total,
            span_wait_s=[round(x, 4) for x in waits.tolist()],
            encode_s=[round(x, 4) for x in encs.tolist()],
            plan_scan_s=round(scan_s, 4),
            gather_s=round(gather_s, 4),
            dcn_payload_bytes=int(payload.sum()),
            modeled_single_host_s=round(t1, 4),
            modeled_parallel_s=round(tn, 4),
            modeled_efficiency=round(t1 / (nproc * max(tn, 1e-9)), 4),
        )
    if blobs is None:
        return b""
    return _stitch(blobs, level)


def encode_multihost_path(
    path: str, level: int = 9, report: dict | None = None,
    device: Devices = "cuda",
) -> bytes:
    """Encode a file across every rank of the default process group;
    returns the stream on rank 0 (b"" on the others).

    Rank 0 mmaps the file and plans spans incrementally while every rank
    (itself included) encodes; every rank reads only its own span.
    ``path`` must be readable by every rank.  Without a process group
    this is ``pipeline.compress`` of the file."""
    block_devices(device)                   # a missing card raises here
    nproc, pid = world()
    if nproc == 1:
        from ..pipeline import compress

        with open(path, "rb") as f:
            return compress(f.read(), level, device)

    total = os.path.getsize(path)
    consumed_iter = None
    mm = None
    f0 = None
    if pid == 0:
        f0 = open(path, "rb")
        try:
            mm = mmap.mmap(f0.fileno(), 0, access=mmap.ACCESS_READ)
            data = mm
        except ValueError:              # empty file
            data = b""
        consumed_iter = (b.consumed for b in iter_blocks(data, level))

    def read_span(span: Span) -> bytes:
        with open(path, "rb") as f:
            f.seek(span.offset)
            return f.read(span.length)

    try:
        return _encode_pipelined(read_span, consumed_iter, total, level,
                                 nproc, pid, report, device)
    finally:
        del consumed_iter
        if mm is not None:
            try:
                mm.close()
            except BufferError:
                pass  # a view still holds the buffer; it goes with GC
        if f0 is not None:
            f0.close()


def encode_multihost(
    data: bytes, level: int = 9, report: dict | None = None,
    device: Devices = "cuda",
) -> bytes:
    """Encode in-memory bytes across every rank (the stream on rank 0).

    Only rank 0's ``data`` is read for planning: it plans the spans and
    broadcasts the table, and every rank encodes
    ``data[offset:offset + length]`` of its own copy, so every rank must
    be handed the same bytes.  For inputs too large to replicate, use
    ``encode_multihost_path``.  Without a process group this is
    ``pipeline.compress``."""
    block_devices(device)                   # a missing card raises here
    nproc, pid = world()
    if nproc == 1:
        from ..pipeline import compress

        return compress(data, level, device)

    consumed_iter = (
        (b.consumed for b in iter_blocks(data, level)) if pid == 0 else None
    )

    def read_span(span: Span) -> bytes:
        return data[span.offset : span.offset + span.length]

    return _encode_pipelined(read_span, consumed_iter, len(data), level,
                             nproc, pid, report, device)
