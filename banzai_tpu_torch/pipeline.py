"""Orchestration: host RLE1 blocks -> overlapped device batches -> stream.

Counterpart of ``banzai_tpu/pipeline.py`` (``compress_blocks_iter``,
``compress_blocks_payloads``, ``compress``) on one device.  A call of
``compress_blocks_iter`` runs three threads beside its caller:

* producer: pulls RLE1 blocks from the caller's iterator (so RLE1 of the
  next blocks runs here), tags each with a sequence id, encodes tiny
  blocks on the host and hands blocks to idle hybrid workers, forms the
  batches (a quarter batch, a full batch, then windows of
  ``_SORT_WINDOW`` batches stable-sorted by ``_hardness``) and stages each
  batch's rows into pinned host memory;
* device: uploads a batch, runs ``block.encode_batch_rows`` on the one
  compute stream of the call, packs the per-block head and the first
  ``k`` words of every row into one buffer, starts its copy into pinned
  host memory and records an event;
* drain: waits for the event, refetches the words at a wider bucket on a
  miss, checks every block (word capacity, the <=-banzai contract) and
  files its payload under its sequence id.

The caller's generator yields (block, payload) in input order.  The
device work sits on a thread of its own because the BWT waits for the
device once per doubling round (``ops/bwt.py``); RLE1 and staging on
that thread would not overlap the device.  Bounded queues hold at most
``_STAGED`` staged and ``_INFLIGHT`` fetched batches.

A device failure raises out of the generator, and every thread is joined
when the generator finishes, fails or is closed.  Blocks go to the host
encoder only by rule: tiny blocks, a payload past the word capacity, a
block where banzai's exact plan is strictly smaller, or a block stolen by
an opt-in hybrid worker.
"""

from __future__ import annotations

import atexit
import itertools
import os
import queue
import threading
import time
import warnings
from contextlib import ExitStack, contextmanager
from dataclasses import dataclass, field

import numpy as np
import torch

from banzai_tpu.bitio import BitWriter
from banzai_tpu.constants import MAX_SYMS as S, SEGMENT_WIDTH, block_capacity
from banzai_tpu.container import write_stream_footer, write_stream_header
from banzai_tpu.crc32 import combine_stream_crc
from banzai_tpu.encoder_host import TINY_BLOCK, block_plan, hybrid_block
from banzai_tpu.huffman_host import banzai_wins, write_entropy
from banzai_tpu.rle1 import iter_blocks

from ._device import resolve_device
from .block import ROW_EXTRA, encode_batch_rows, nvtx_range, stage
from .payload import BlockPayload

_CHUNK = 64           # MTF chunk length
_DEFAULT_BATCH = 8    # blocks per device batch at level >= 5
_STAGED = 2           # staged batches queued ahead of the device thread
_INFLIGHT = 3         # fetched batches queued ahead of the drain
_SORT_WINDOW = 4      # batches per hardness-sorted window
_POLL = 0.1           # s between stop checks of a thread blocked on a queue

_K_SEED: dict = {}    # (level, N) -> the last call's word-bucket window


@dataclass
class EncodeStats:
    """What a ``compress`` call did, for callers that want to know.

    ``device_blocks`` counts blocks encoded on the device path; the
    ``host_*`` fields count blocks that went to the host encoder, by rule
    (``host_hybrid``: stolen by a hybrid worker).  ``refetches`` counts
    word fetches repeated at a wider bucket.  ``host_ms`` sums the wall
    time (ms) of each host step on its own thread, without waiting for
    the device.  When ``stage_ms`` is a dict, every device stage
    synchronises the device and adds its wall time (ms) there; when it is
    None (the default) nothing waits."""
    device_blocks: int = 0
    host_tiny: int = 0
    host_capacity: int = 0
    host_banzai: int = 0
    host_hybrid: int = 0
    batches: int = 0
    refetches: int = 0
    stage_ms: dict | None = None
    host_ms: dict = field(default_factory=dict)


def _batch_for_level(level: int) -> int:
    """Device batch: small blocks take bigger batches."""
    if level <= 2:
        return 64
    if level <= 4:
        return 32
    return _DEFAULT_BATCH


def _padded_len(level: int) -> int:
    cap = block_capacity(level)
    return ((cap + _CHUNK - 1) // _CHUNK) * _CHUNK


def _nwords(N: int, nseg: int) -> int:
    # Every winning plan fits 9.25 bits/symbol plus its selectors and two
    # table definitions (the single-optimal-table candidate costs at most
    # log2(258) + 1 bits/symbol); the drain re-checks nbits against this
    # capacity and host-encodes any block past it.
    worst = 18 + 6 * nseg + 2 * (5 + S * 34) + (37 * (N + 1)) // 4
    return (worst + 31) // 32 + 2


def _bucket(n: int) -> int:
    k = 256
    while k < n:
        k *= 2
    return k


def _hardness(out: np.ndarray) -> float:
    """Cheap predictor of a block's BWT sort difficulty: the largest
    agreement of the RLE1 bytes with themselves shifted by 1..8, on 4
    samples of 4096 bytes for a block over 16 KB.

    A periodic block keeps rotation tie groups alive for more doubling
    rounds, and a batch runs until its slowest block is done, so the
    producer sorts windows of blocks by this score (the same function as
    ``banzai_tpu.pipeline._hardness``)."""
    n = out.size
    if n > 16384:
        step = n // 4
        out = np.concatenate(
            [out[i * step : i * step + 4096] for i in range(4)]
        )
    best = 0.0
    for q in (1, 2, 3, 4, 5, 6, 7, 8):
        m = float(np.mean(out[q:] == out[:-q]))
        if m > best:
            best = m
    return best


def _host_payload(blk) -> BlockPayload:
    """Encode one block's entropy payload with the host encoder."""
    ptr, present, syms, plan = block_plan(blk.output)
    bw = BitWriter()
    write_entropy(bw, syms, plan)
    nbits = bw.bit_length
    raw = bw.close()
    raw += b"\x00" * (-len(raw) % 4)
    words = np.frombuffer(raw, dtype=">u4").astype(np.uint32)
    return BlockPayload(
        crc=blk.crc, ptr=ptr, present=present, words=words, nbits=nbits
    )


def stage_rows(
    outputs: list[np.ndarray], N: int, batch: int, pin_memory: bool = False
):
    """Pack RLE1 block outputs into one uint8 [tgt, N + 260] row tensor
    (pinned host memory when ``pin_memory``).

    tgt is the next power of two >= len(outputs), at most ``batch``;
    dummy rows hold one byte 0.  Returns (rows, present bool [tgt, 256])."""
    tgt = min(batch, 1 << (len(outputs) - 1).bit_length())
    rows = torch.zeros((tgt, N + ROW_EXTRA), dtype=torch.uint8,
                       pin_memory=pin_memory)
    arr = rows.numpy()
    arr[:, N] = 1                            # dummy blocks: byte 0
    arr[:, N + 256] = 1                      # present, length 1
    pres = np.zeros((tgt, 256), bool)
    pres[:, 0] = True
    for i, out in enumerate(outputs):
        nb = len(out)
        arr[i, :nb] = out
        p = np.bincount(out, minlength=256) > 0
        pres[i] = p
        arr[i, N : N + 256] = p
        arr[i, N + 256] = nb & 0xFF
        arr[i, N + 257] = (nb >> 8) & 0xFF
        arr[i, N + 258] = (nb >> 16) & 0xFF
    return rows, pres


# ---- Hybrid host stealing -------------------------------------------------
# Opt-in (BANZAI_HYBRID_JOBS=J or hybrid_jobs=J): while the device works,
# J worker processes encode stolen blocks with the host encoder
# (encoder_host.hybrid_block, byte-identical), so idle host cores add
# throughput.  Workers are spawned, never forked: fork after CUDA
# initialisation is broken, and the parent runs threads.

_HYBRID_POOL = None
_HYBRID_POOL_JOBS = 0


def _shutdown_hybrid_pool() -> None:
    """atexit: end the workers while the interpreter is whole."""
    global _HYBRID_POOL
    if _HYBRID_POOL is not None:
        _HYBRID_POOL.terminate()
        _HYBRID_POOL.join()
        _HYBRID_POOL = None


def _hybrid_pool(jobs: int):
    global _HYBRID_POOL, _HYBRID_POOL_JOBS
    if _HYBRID_POOL is None or _HYBRID_POOL_JOBS != jobs:
        if _HYBRID_POOL is not None:
            _HYBRID_POOL.terminate()
        from banzai_tpu.utils.pool import spawn_pool

        _HYBRID_POOL = spawn_pool(jobs)
        if _HYBRID_POOL_JOBS == 0:           # first pool of this process
            atexit.register(_shutdown_hybrid_pool)
        _HYBRID_POOL_JOBS = jobs
    return _HYBRID_POOL


# ---- The scheduler --------------------------------------------------------

_STREAMS: dict = {}   # device index -> (compute, refetch) streams
_STREAMS_LOCK = threading.Lock()


def _streams(dev: torch.device):
    """The device's compute and refetch streams, the same for every call
    in this process: the caching allocator reuses a freed block only on
    the stream it was allocated on, so a new stream per call would take
    every call's workspace from cudaMalloc afresh."""
    with _STREAMS_LOCK:
        if dev.index not in _STREAMS:
            _STREAMS[dev.index] = (torch.cuda.Stream(dev),
                                   torch.cuda.Stream(dev))
        return _STREAMS[dev.index]



class _Scheduler:
    """The threads of one ``compress_blocks_iter`` call and their state."""

    def __init__(self, blocks, level, dev, batch, hybrid_jobs, stats):
        self.blocks = blocks
        self.dev = dev
        self.batch = batch
        self.stats = stats
        self.N = N = _padded_len(level)
        self.nseg = (N + 1 + SEGMENT_WIDTH - 1) // SEGMENT_WIDTH
        self.nwords = _nwords(N, self.nseg)
        self.seed_key = (level, N)
        self.cuda = dev.type == "cuda"
        if self.cuda:
            self.compute, self.refetch_stream = _streams(dev)
        self.hybrid_jobs = hybrid_jobs
        self.pool = _hybrid_pool(hybrid_jobs) if hybrid_jobs > 0 else None

        self.staged: queue.Queue = queue.Queue(maxsize=_STAGED)
        self.fetched: queue.Queue = queue.Queue(maxsize=_INFLIGHT)
        self.stop = threading.Event()
        # Guards results, host_jobs, errors and total; signals each change.
        self.avail = threading.Condition()
        self.results: dict[int, tuple[BlockPayload, str]] = {}
        self.host_jobs: dict[int, tuple] = {}   # seq -> (blk, AsyncResult)
        self.blk_map: dict[int, object] = {}    # seq -> block, until yielded
        self.errors: list[BaseException] = []
        self.nseq = 0
        self.total: int | None = None           # block count, once known
        # Adaptive word bucket: the fetch width follows the largest payload
        # of the last 3 batches, seeded from the last call at this shape.
        self.k_lock = threading.Lock()
        self.k_recent = list(_K_SEED.get(self.seed_key, (256, 256, 256)))
        self.ms_lock = threading.Lock()
        self.threads = [
            threading.Thread(target=self._guard, args=(fn,), daemon=True,
                             name=f"banzai_tpu_torch-{fn.__name__[1:]}")
            for fn in (self._producer, self._device, self._drain)
        ]

    # -- plumbing ----------------------------------------------------------

    def _guard(self, fn) -> None:
        """Thread body: any exception goes to the caller, who re-raises it,
        and stops the other threads."""
        try:
            fn()
        except BaseException as e:
            with self.avail:
                self.errors.append(e)
                self.avail.notify_all()
            self.stop.set()

    def _put(self, q: queue.Queue, item) -> bool:
        while not self.stop.is_set():
            try:
                q.put(item, timeout=_POLL)
                return True
            except queue.Full:
                continue
        return False

    def _get(self, q: queue.Queue):
        while not self.stop.is_set():
            try:
                return q.get(timeout=_POLL)
            except queue.Empty:
                continue
        return None

    def _file(self, seq: int, payload: BlockPayload, route: str) -> None:
        with self.avail:
            self.results[seq] = (payload, route)
            self.avail.notify_all()

    @contextmanager
    def _step(self, name: str):
        """A host step: an NVTX range on CUDA, and its wall time (ms) added
        to ``stats.host_ms[name]``."""
        t0 = time.perf_counter()
        try:
            with nvtx_range(name, self.dev):
                yield
        finally:
            dt = 1e3 * (time.perf_counter() - t0)
            with self.ms_lock:
                ms = self.stats.host_ms
                ms[name] = ms.get(name, 0.0) + dt

    def _k_now(self) -> int:
        with self.k_lock:
            return min(max(max(self.k_recent), 256), self.nwords)

    # -- producer ----------------------------------------------------------

    def _tagged(self):
        """Sequence-tagged blocks bound for the device; tiny blocks are
        encoded here and idle hybrid workers take blocks in between."""
        it = iter(self.blocks)
        while not self.stop.is_set():
            with self._step("rle1_iter"):
                blk = next(it, None)
            if blk is None:
                return
            seq = self.nseq
            self.blk_map[seq] = blk
            self.nseq += 1
            if len(blk.output) <= TINY_BLOCK:
                # Only a stream's final block can be this small; padding it
                # to the full device shape would waste a batch slot.
                with self._step("host_tiny"):
                    self._file(seq, _host_payload(blk), "host_tiny")
                continue
            if self.pool is not None:
                with self.avail:
                    active = sum(1 for _b, ar in self.host_jobs.values()
                                 if not ar.ready())
                    if active < self.hybrid_jobs:
                        self.host_jobs[seq] = (blk, self.pool.apply_async(
                            hybrid_block, (np.ascontiguousarray(blk.output),)
                        ))
                        self.avail.notify_all()
                        continue
            yield seq, blk

    def _stage(self, group) -> bool:
        with self._step("stage"):
            rows, pres = stage_rows([b.output for _s, b in group], self.N,
                                    self.batch, pin_memory=self.cuda)
        return self._put(self.staged, (group, rows, pres))

    def _producer(self) -> None:
        tagged = self._tagged()
        batch = self.batch
        # The first dispatch is a quarter batch, so the device starts
        # sooner; the first two go out without a window.
        for size in (max(1, batch // 4), batch):
            first = list(itertools.islice(tagged, size))
            if not first or not self._stage(first):
                break
        else:
            while True:
                window = list(itertools.islice(tagged, batch * _SORT_WINDOW))
                if not window:
                    break
                if len(window) > batch:
                    # Similar-hardness blocks share batches, so a periodic
                    # straggler does not hold up a batch of easy blocks
                    # (the sort is stable: equal scores keep input order).
                    with self._step("hardness_sort"):
                        window.sort(key=lambda sb: _hardness(sb[1].output))
                if not all(self._stage(window[g : g + batch])
                           for g in range(0, len(window), batch)):
                    break
        if self.stop.is_set():
            return
        with self.avail:
            self.total = self.nseq
            self.avail.notify_all()
        self._put(self.staged, None)

    # -- device ------------------------------------------------------------

    def _device(self) -> None:
        with ExitStack() as ctx:
            if self.cuda:
                # The current device and stream are per thread.
                ctx.enter_context(torch.cuda.device(self.dev))
                ctx.enter_context(torch.cuda.stream(self.compute))
            while True:
                item = self._get(self.staged)
                if item is None:
                    break
                if not self._put(self.fetched, self._run_batch(*item)):
                    return
        self._put(self.fetched, None)

    def _run_batch(self, group, rows_h, pres):
        """Upload, encode and start the fetch of one batch (on the compute
        stream); returns the drain's work item."""
        B = len(group)
        sm = self.stats.stage_ms
        with stage(sm, "upload", self.dev):
            rows = rows_h.to(self.dev, non_blocking=True)
        with self._step("dispatch"):
            words_d, nbits_d, ptrs_d, planb_d, splits_d, mlens_d = (
                encode_batch_rows(rows, nseg=self.nseg, nwords=self.nwords,
                                  chunk=_CHUNK, stage_ms=sm)
            )
        k = self._k_now()
        with stage(sm, "fetch", self.dev):
            # One fetch: nbits, ptr, plan bits, RLE2 length, banzai split,
            # then words[:, :k], all as int32 (uint32 bit patterns).
            packed = torch.cat([
                t[:B].reshape(-1).to(torch.int32)
                for t in (nbits_d, ptrs_d, planb_d, mlens_d, splits_d,
                          words_d[:, :k])
            ])
            if self.cuda:
                host = torch.empty(packed.shape, dtype=torch.int32,
                                   pin_memory=True)
                host.copy_(packed, non_blocking=True)
                done = torch.cuda.Event()
                done.record()
            else:
                host, done = packed, None
        # words_d stays referenced until the drain is done with the batch,
        # for a refetch on a bucket miss.
        return group, pres, host, done, words_d, k

    # -- drain -------------------------------------------------------------

    def _drain(self) -> None:
        while True:
            item = self._get(self.fetched)
            if item is None:
                return
            self._drain_one(*item)

    def _drain_one(self, group, pres, host, done, words_d, k) -> None:
        B = len(group)
        nwords = self.nwords
        with self._step("drain_fetch"):
            if done is not None:
                done.synchronize()
        with self._step("drain"):
            flat = host.numpy()
            nbits = flat[:B].astype(np.int64)
            ptrs = flat[B : 2 * B]
            plan_bits = flat[2 * B : 3 * B].astype(np.int64)
            mlens = flat[3 * B : 4 * B].astype(np.int64)
            head = 4 * B + 3 * S * B
            splits = flat[4 * B : head].reshape(B, 3, S)
            # A copy, so the pinned buffer goes back to the allocator.
            words = flat[head:].reshape(B, k).view(np.uint32).copy()
            kmax = max(1, (int(nbits.max()) + 31) // 32)
            want = min(_bucket(kmax), nwords)
            with self.k_lock:
                self.k_recent.append(want)
                del self.k_recent[:-3]
            if min(kmax, nwords) > k:
                # Bucket miss: fetch again at the wider bucket.
                self.stats.refetches += 1
                words = self._refetch(words_d[:B, :want])
            self.stats.batches += 1
            for i, (seq, blk) in enumerate(group):
                if int(nbits[i]) > nwords * 32:
                    # Past the word capacity (see _nwords): the device
                    # words are truncated, so encode on the host.
                    self._file(seq, _host_payload(blk), "host_capacity")
                elif banzai_wins(splits[i], int(pres[i].sum()) + 2,
                                 int(mlens[i]), int(plan_bits[i])):
                    # The <=-banzai contract: banzai's exact plan is
                    # strictly smaller; the host encoder's candidates
                    # include it.
                    self._file(seq, _host_payload(blk), "host_banzai")
                else:
                    self._file(seq, BlockPayload(
                        crc=blk.crc, ptr=int(ptrs[i]), present=pres[i],
                        words=words[i], nbits=int(nbits[i]),
                    ), "device_blocks")

    def _refetch(self, words: torch.Tensor) -> np.ndarray:
        if not self.cuda:
            return words.numpy().view(np.uint32).copy()
        # The batch's event has completed, so the words are final; the
        # copy runs on a stream of its own and waits only for itself.
        with torch.cuda.device(self.dev), torch.cuda.stream(
            self.refetch_stream
        ):
            return words.cpu().numpy().view(np.uint32)

    # -- the caller's side ---------------------------------------------------

    def _resolve_hybrid(self, seq: int) -> BlockPayload:
        with self.avail:
            blk, ar = self.host_jobs.pop(seq)
        try:
            # Bounded: a worker lost mid-task leaves its result pending.
            ptr, present, words, nb = ar.get(timeout=300)
        except Exception as e:
            # Host for host: the block is encoded inline instead.
            warnings.warn(
                f"hybrid host worker failed ({type(e).__name__}: {e}); "
                "re-encoding the block inline"
            )
            return _host_payload(blk)
        return BlockPayload(crc=blk.crc, ptr=ptr, present=present,
                            words=words, nbits=nb)

    def run(self):
        for t in self.threads:
            t.start()
        seq = 0
        stats = self.stats
        try:
            while True:
                with self.avail:
                    while True:
                        if seq in self.results:
                            payload, route = self.results.pop(seq)
                            break
                        if seq in self.host_jobs:
                            payload, route = None, "host_hybrid"
                            break
                        if self.errors:
                            raise self.errors[0]
                        if self.total is not None and seq >= self.total:
                            return
                        self.avail.wait(_POLL)
                if payload is None:
                    payload = self._resolve_hybrid(seq)
                setattr(stats, route, getattr(stats, route) + 1)
                yield self.blk_map.pop(seq), payload
                seq += 1
        finally:
            self.stop.set()
            for t in self.threads:
                if t.is_alive():
                    t.join()
            with self.k_lock:
                _K_SEED[self.seed_key] = tuple(self.k_recent)


def compress_blocks_iter(
    block_iter,
    level: int = 9,
    device: str | torch.device = "cuda",
    batch: int | None = None,
    hybrid_jobs: int | None = None,
    stats: EncodeStats | None = None,
):
    """Encode a stream of RLE1 blocks; yield (block, payload) in input
    order as payloads complete.

    ``batch``: blocks per device batch (default by level).
    ``hybrid_jobs`` (default BANZAI_HYBRID_JOBS, else 0): host worker
    processes that encode stolen blocks beside the device, byte-identical
    at any count.  They are spawned, so a script that asks for them
    guards its entry point with ``if __name__ == "__main__":``.
    ``stats``, when given, receives the route counts and host timings.
    The threads start at the first ``next`` and are joined when the
    generator ends, raises or is closed."""
    dev = resolve_device(device)
    if batch is None:
        batch = _batch_for_level(level)
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    if hybrid_jobs is None:
        hybrid_jobs = int(os.environ.get("BANZAI_HYBRID_JOBS", "0"))
    sched = _Scheduler(block_iter, level, dev, batch, hybrid_jobs,
                       stats if stats is not None else EncodeStats())
    return sched.run()


def compress_blocks_payloads(
    data: bytes,
    level: int = 9,
    device: str | torch.device = "cuda",
    stats: EncodeStats | None = None,
    *,
    batch: int | None = None,
    hybrid_jobs: int | None = None,
) -> list[BlockPayload]:
    """Encode ``data`` into per-block payloads, in input order."""
    return [p for _blk, p in compress_blocks_iter(
        iter_blocks(data, level), level, device, batch=batch,
        hybrid_jobs=hybrid_jobs, stats=stats,
    )]


def compress(
    data: bytes,
    level: int = 9,
    device: str | torch.device = "cuda",
    stats: EncodeStats | None = None,
    *,
    batch: int | None = None,
    hybrid_jobs: int | None = None,
) -> bytes:
    """Encode ``data`` into a .bz2 stream on ``device``."""
    bw = BitWriter()
    write_stream_header(bw, level)
    stream_crc = 0
    for p in compress_blocks_payloads(data, level, device, stats,
                                      batch=batch, hybrid_jobs=hybrid_jobs):
        stream_crc = combine_stream_crc(stream_crc, p.crc)
        p.write(bw)
    write_stream_footer(bw, stream_crc)
    return bw.close()
