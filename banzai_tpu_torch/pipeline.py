"""Orchestration: host RLE1 blocks -> overlapped device batches -> stream.

Counterpart of ``banzai_tpu/pipeline.py`` (``compress_blocks_iter``,
``compress_blocks_payloads``, ``compress``).  A call of
``compress_blocks_iter`` runs these threads beside its caller:

* producer: pulls RLE1 blocks from the caller's iterator (so RLE1 of the
  next blocks runs here), tags each with a sequence id, encodes tiny
  blocks on the host and hands blocks to idle hybrid workers, forms the
  batches (a quarter batch, a full batch, then windows of
  ``_SORT_WINDOW`` batches stable-sorted by ``_hardness``) and stages each
  batch's rows into pinned host memory;
* device, one per entry of ``parallel.dp.block_devices(device)``: takes
  the next staged batch, uploads it to its device, runs ``block.encode_batch_rows`` on that device's compute stream, packs the
  per-block head and the first ``k`` words of every row into one buffer,
  starts its copy into pinned host memory and records an event;
* drain: waits for the event, refetches the words at a wider bucket on a
  miss (from the batch's device), checks every block (word capacity, the
  <=-banzai contract) and files its payload under its sequence id.

The caller's generator yields (block, payload) in input order.  The
device work sits on a thread of its own because the BWT waits for the
device once per doubling round (``ops/bwt.py``); RLE1 and staging on
that thread would not overlap the device.  Bounded queues hold at most
``_STAGED`` staged and ``_INFLIGHT`` fetched batches.  With D device
threads the producer ends the staged queue with D end markers, each
device thread passes one on to the drain, and the drain stops at the
D-th.  Several device threads in one process share the interpreter lock;
one process per card (``parallel/multihost.py``) does not.

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
import warnings
import weakref
from contextlib import ExitStack
from dataclasses import dataclass, field

import numpy as np
import torch

from .bitio import BitWriter
from .constants import MAX_SYMS as S, SEGMENT_WIDTH, block_capacity
from .container import write_stream_footer, write_stream_header
from .crc32 import combine_stream_crc
from .encoder_host import TINY_BLOCK, block_plan, hybrid_block
from .huffman_host import banzai_wins, write_entropy
from .rle1 import iter_blocks
from ._build import thread_launches
from .block import ROW_EXTRA, encode_batch_rows, stage
from .parallel.dp import Devices, block_devices
from .payload import BlockPayload
from .spans import Binding, Recorder, Span, Timeline, flush, span

_CHUNK = 64           # row padding multiple (the JAX pipeline's MTF chunk)
_DEFAULT_BATCH = 8    # blocks per device batch at level >= 5
_STAGED = 2           # staged batches queued ahead of the device thread
_INFLIGHT = 3         # fetched batches queued ahead of the drain
_SORT_WINDOW = 4      # batches per hardness-sorted window
_POLL = 0.1           # s between stop checks of a thread blocked on a queue

_K_SEED: dict = {}    # (level, N) -> the last call's word-bucket window


@dataclass
class EncodeStats:
    """What ``compress`` calls did, for callers that want to know; one
    object may gather several calls.

    Blocks by route: ``device_blocks`` counts blocks encoded on the device
    path; ``host_tiny``, ``host_capacity``, ``host_banzai`` and
    ``host_hybrid`` count blocks that went to the host encoder, by rule
    (a tiny last block, a payload past the word capacity, banzai's exact
    plan strictly smaller, stolen by a hybrid worker).
    ``plan_kernel_blocks`` counts the device blocks whose entropy plan
    kernel K5 computed (``ops.plan_kernel``): the batch's device thread
    launched its entry point.

    Batches: ``batches`` counts the device batches the drain checked, and
    ``device_batches`` those of each device thread, in the order of
    ``parallel.dp.block_devices``.  ``refetches`` counts word fetches
    repeated at a wider bucket.

    Times, all in ms and summed over the calls, none of which waits for
    the device (``spans``); they are taken only in calls given these
    stats, not in the stats a call makes for itself:

    * ``host_ms[name]``: the wall time of each host span on its thread.
      Producer: ``rle1_iter``, ``host_tiny``, ``hardness_sort``,
      ``stage``, ``producer_wait_staged``.  Device thread:
      ``device_wait_staged``, ``upload``, ``dispatch`` (holding the
      stages ``bwt``, ``mtf``, ``rle2``, ``plan``, ``entries``, ``pack``),
      ``fetch``, ``device_wait_fetched``, and ``sync``, the host's waits
      for the device at its reads of device values.  Drain:
      ``drain_wait_fetched``, ``drain_fetch`` (the wait for a batch's
      copy), ``drain``.  Caller: ``caller_wait``, for its next payload.
      Spans nest (``sync`` lies inside ``bwt``, inside ``dispatch``), so
      the names do not add up to a thread's time.
    * ``cpu_ms["dispatch"]``: the device thread's CPU time in
      ``dispatch``; ``host_ms - cpu_ms`` is the time it was off the CPU.
      No other span reads the CPU clock, a system call on some hosts.
    * ``device_ms[name]``: on CUDA, the card's time between timing events
      on the compute stream: ``bwt`` and ``plan`` (each from an event at
      the stage's start to one at its end), ``gap`` (from the end of the
      stream's previous batch, when these stats recorded it, to the start
      of the next, its upload) and ``gap_starved`` (of each gap, no more
      than the device thread's wait for a staged batch before it).  With
      ``stage_ms`` a dict, a stage's start event follows its first
      synchronisation, as its ``stage_ms`` does.  Empty on the CPU.
    * ``stage_ms``: when a dict, every device stage synchronises the
      device before and after and adds its wall time there; when None
      (the default) nothing waits."""
    device_blocks: int = 0
    plan_kernel_blocks: int = 0
    host_tiny: int = 0
    host_capacity: int = 0
    host_banzai: int = 0
    host_hybrid: int = 0
    batches: int = 0
    device_batches: list = field(default_factory=list)
    refetches: int = 0
    stage_ms: dict | None = None
    host_ms: dict = field(default_factory=dict)
    cpu_ms: dict = field(default_factory=dict)
    device_ms: dict = field(default_factory=dict)


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
        from .utils.pool import spawn_pool

        _HYBRID_POOL = spawn_pool(jobs)
        if _HYBRID_POOL_JOBS == 0:           # first pool of this process
            atexit.register(_shutdown_hybrid_pool)
        _HYBRID_POOL_JOBS = jobs
    return _HYBRID_POOL


# ---- The scheduler --------------------------------------------------------

_STREAMS: dict = {}   # device index -> (compute, refetch) streams
_STREAMS_LOCK = threading.Lock()
# device index -> (the end event of the last batch on its compute stream,
# a weak reference to the EncodeStats it was recorded for); under
# _STREAMS_LOCK.
_LAST_END: dict = {}
_FREE_EVENTS: dict = {}   # device index -> timing events to reuse


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

    def __init__(self, blocks, level, devs, batch, hybrid_jobs, stats,
                 record):
        self.blocks = blocks
        self.devs = devs
        self.batch = batch
        self.stats = stats
        self.N = N = _padded_len(level)
        self.nseg = (N + 1 + SEGMENT_WIDTH - 1) // SEGMENT_WIDTH
        self.nwords = _nwords(N, self.nseg)
        self.seed_key = (level, N)
        self.cuda = devs[0].type == "cuda"
        # Each device thread counts its batches in its own slot.
        stats.device_batches += [0] * (len(devs) - len(stats.device_batches))
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
        # Spans and marks go to the stats only when the caller gave them.
        self.record = record
        self.rec = Recorder(stats if record else None)
        self.caller = Binding(self.rec)         # the caller's thread's
        self.nstaged = 0                        # batches staged so far
        bodies = [("producer", self._producer, ())]
        bodies += [(f"device{i}", self._device, (i,))
                   for i in range(len(devs))]
        bodies.append(("drain", self._drain, ()))
        self.threads = [
            threading.Thread(target=self._guard, args=(fn, *args),
                             daemon=True, name=f"banzai_tpu_torch-{name}")
            for name, fn, args in bodies
        ]

    # -- plumbing ----------------------------------------------------------

    def _guard(self, fn, *args) -> None:
        """Thread body: any exception goes to the caller, who re-raises it,
        and stops the other threads."""
        try:
            fn(*args)
        except BaseException as e:
            with self.avail:
                self.errors.append(e)
                self.avail.notify_all()
            self.stop.set()
        finally:
            flush()                     # the thread's last span sums

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

    def _file(self, seq: int, payload: BlockPayload, *routes: str) -> None:
        """Hand a block's payload to the caller; each of ``routes`` names a
        count of ``EncodeStats`` that the block adds one to."""
        with self.avail:
            self.results[seq] = (payload, routes)
            self.avail.notify_all()

    def _k_now(self) -> int:
        with self.k_lock:
            return min(max(max(self.k_recent), 256), self.nwords)

    # -- producer ----------------------------------------------------------

    def _tagged(self):
        """Sequence-tagged blocks bound for the device; tiny blocks are
        encoded here and idle hybrid workers take blocks in between."""
        it = iter(self.blocks)
        while not self.stop.is_set():
            with span("rle1_iter"):
                blk = next(it, None)
            if blk is None:
                return
            seq = self.nseq
            self.blk_map[seq] = blk
            self.nseq += 1
            if len(blk.output) <= TINY_BLOCK:
                # Only a stream's final block can be this small; padding it
                # to the full device shape would waste a batch slot.
                with span("host_tiny"):
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
        idx = self.nstaged
        self.nstaged += 1
        self.rec.bind(idx)
        with span("stage"):
            rows, pres = stage_rows([b.output for _s, b in group], self.N,
                                    self.batch, pin_memory=self.cuda)
        with span("producer_wait_staged"):
            ok = self._put(self.staged, (idx, group, rows, pres))
        self.rec.bind()
        return ok

    def _producer(self) -> None:
        self.rec.bind()
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
                    with span("hardness_sort"):
                        window.sort(key=lambda sb: _hardness(sb[1].output))
                if not all(self._stage(window[g : g + batch])
                           for g in range(0, len(window), batch)):
                    break
        if self.stop.is_set():
            return
        with self.avail:
            self.total = self.nseq
            self.avail.notify_all()
        for _ in self.devs:             # one end marker per device thread
            with span("producer_wait_staged"):
                if not self._put(self.staged, None):
                    return

    # -- device ------------------------------------------------------------

    def _device(self, i: int) -> None:
        dev = self.devs[i]
        with ExitStack() as ctx:
            if self.cuda:
                # The current device and stream are per thread.
                ctx.enter_context(torch.cuda.device(dev))
                ctx.enter_context(torch.cuda.stream(_streams(dev)[0]))
            while True:
                self.rec.bind()
                with span("device_wait_staged") as wait:
                    item = self._get(self.staged)
                if item is None:
                    break
                b, group, rows_h, pres = item
                tl = prev = None
                if self.cuda:
                    tl = Timeline(_streams(dev)[0],
                                  _FREE_EVENTS.setdefault(dev.index, []))
                    if self.record:
                        prev = self._batch_start(dev, tl)
                self.rec.bind(b, tl if self.record else None)
                work = self._run_batch(dev, group, rows_h, pres)
                if tl is not None:
                    tl.mark(None)       # the batch's end: after the fetch
                    if self.record:
                        with _STREAMS_LOCK:
                            _LAST_END[dev.index] = (tl.end,
                                                    weakref.ref(self.stats))
                waited = wait.ms if self.record else 0.0
                with span("device_wait_fetched"):
                    if not self._put(self.fetched,
                                     (*work, b, tl, prev, waited)):
                        return
                self.stats.device_batches[i] += 1
        with span("device_wait_fetched"):
            self._put(self.fetched, None)

    def _run_batch(self, dev, group, rows_h, pres):
        """Upload, encode and start the fetch of one batch (on ``dev``'s
        compute stream), under the spans and marks bound to this thread;
        returns the head of the drain's work item."""
        B = len(group)
        sm = self.stats.stage_ms
        with stage(sm, "upload", dev):
            rows = rows_h.to(dev, non_blocking=True)
        planned = thread_launches("entropy_plan")
        with span("dispatch", cpu=True):
            words_d, nbits_d, ptrs_d, planb_d, splits_d, mlens_d = (
                encode_batch_rows(rows, nseg=self.nseg, nwords=self.nwords,
                                  stage_ms=sm)
            )
        planned = thread_launches("entropy_plan") > planned
        k = self._k_now()
        with stage(sm, "fetch", dev):
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
            else:
                host = packed
        # words_d stays referenced until the drain is done with the batch,
        # for a refetch on a bucket miss.
        return dev, group, pres, host, words_d, k, planned

    def _batch_start(self, dev, tl: Timeline):
        """Mark the start of the next batch on ``dev``'s compute stream on
        ``tl``; return the end event of the stream's previous batch if
        this call's stats recorded it, else None."""
        with _STREAMS_LOCK:
            # Popped: a batch that starts before this one ends finds none.
            prev = _LAST_END.pop(dev.index, None)
            tl.mark("start")
        if prev is None or prev[1]() is not self.stats:
            return None
        return prev[0]

    # -- drain -------------------------------------------------------------

    def _drain(self) -> None:
        live = len(self.devs)           # device threads not yet finished
        while live:
            self.rec.bind()
            with span("drain_wait_fetched"):
                item = self._get(self.fetched)
            if item is None:
                if self.stop.is_set():
                    return
                live -= 1
                continue
            self._drain_one(*item)

    def _drain_one(self, dev, group, pres, host, words_d, k, planned, b, tl,
                   prev, waited_ms) -> None:
        B = len(group)
        nwords = self.nwords
        self.rec.bind(b)
        if tl is not None:
            with span("drain_fetch"):
                tl.end.synchronize()    # the fetch's mark ends the batch
            if self.record:
                self._device_times(tl, prev, waited_ms)
            tl.recycle(self.record, prev)
        with span("drain"):
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
                words = self._refetch(dev, words_d[:B, :want])
            self.stats.batches += 1
            device = ("device_blocks",) + (
                ("plan_kernel_blocks",) if planned else ())
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
                    ), *device)

    def _device_times(self, tl: Timeline, prev, waited_ms) -> None:
        """Add a completed batch's stage times and the gap before it, on
        the card's clock, to ``stats.device_ms``."""
        ms = tl.stage_ms()
        if prev is not None:
            # The batch's first mark follows the end of the device
            # thread's wait for it, so both intervals end together.
            gap = prev.elapsed_time(tl.start)
            ms["gap"] = gap
            ms["gap_starved"] = min(gap, waited_ms)
        with self.rec.lock:
            dm = self.stats.device_ms
            for name, v in ms.items():
                dm[name] = dm.get(name, 0.0) + v

    def _refetch(self, dev, words: torch.Tensor) -> np.ndarray:
        if not self.cuda:
            return words.numpy().view(np.uint32).copy()
        # The batch's event has completed, so the words are final; the
        # copy runs on a stream of its own on the batch's device and waits
        # only for itself.
        with torch.cuda.device(dev), torch.cuda.stream(_streams(dev)[1]):
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
                with Span(self.caller, "caller_wait"), self.avail:
                    while True:
                        if seq in self.results:
                            payload, routes = self.results.pop(seq)
                            break
                        if seq in self.host_jobs:
                            payload, routes = None, ("host_hybrid",)
                            break
                        if self.errors:
                            raise self.errors[0]
                        if self.total is not None and seq >= self.total:
                            return
                        self.avail.wait(_POLL)
                self.caller.flush()
                if payload is None:
                    payload = self._resolve_hybrid(seq)
                for route in routes:
                    setattr(stats, route, getattr(stats, route) + 1)
                yield self.blk_map.pop(seq), payload
                seq += 1
        finally:
            self.caller.flush()
            self.stop.set()
            for t in self.threads:
                if t.is_alive():
                    t.join()
            with self.k_lock:
                _K_SEED[self.seed_key] = tuple(self.k_recent)


def compress_blocks_iter(
    block_iter,
    level: int = 9,
    device: Devices = "cuda",
    batch: int | None = None,
    hybrid_jobs: int | None = None,
    stats: EncodeStats | None = None,
):
    """Encode a stream of RLE1 blocks; yield (block, payload) in input
    order as payloads complete.

    ``device`` names the devices, one device thread each, as
    ``parallel.dp.block_devices`` resolves them: ``"cuda"`` is the current
    card; a sequence such as ``["cuda:0", "cuda:1"]`` is exactly those
    devices.
    ``batch``: blocks per device batch on each device (default by level).
    ``hybrid_jobs`` (default BANZAI_HYBRID_JOBS, else 0): host worker
    processes that encode stolen blocks beside the device, byte-identical
    at any count.  They are spawned, so a script that asks for them
    guards its entry point with ``if __name__ == "__main__":``.
    ``stats``, when given, receives the route counts and host timings.
    The threads start at the first ``next`` and are joined when the
    generator ends, raises or is closed."""
    devs = block_devices(device)
    if batch is None:
        batch = _batch_for_level(level)
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    if hybrid_jobs is None:
        hybrid_jobs = int(os.environ.get("BANZAI_HYBRID_JOBS", "0"))
    sched = _Scheduler(block_iter, level, devs, batch, hybrid_jobs,
                       stats if stats is not None else EncodeStats(),
                       record=stats is not None)
    return sched.run()


def compress_blocks_payloads(
    data: bytes,
    level: int = 9,
    device: Devices = "cuda",
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
    device: Devices = "cuda",
    stats: EncodeStats | None = None,
    *,
    batch: int | None = None,
    hybrid_jobs: int | None = None,
) -> bytes:
    """Encode ``data`` into a .bz2 stream on ``device`` (as in
    ``compress_blocks_iter``)."""
    bw = BitWriter()
    write_stream_header(bw, level)
    stream_crc = 0
    for p in compress_blocks_payloads(data, level, device, stats,
                                      batch=batch, hybrid_jobs=hybrid_jobs):
        stream_crc = combine_stream_crc(stream_crc, p.crc)
        p.write(bw)
    write_stream_footer(bw, stream_crc)
    return bw.close()
