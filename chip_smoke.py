"""Smoke run of banzai_tpu_torch on one CUDA card.

    python3 chip_smoke.py [--seed N]

Phases, one line each or more:

1. card: the card's name and power limit (nvidia-smi); exits non-zero
   when there is no CUDA device;
2. build: compiles the CUDA kernels from ``banzai_tpu_torch/csrc``, one
   nvcc per source, all started together;
3. kernels: runs K1-K3 at the level-9, batch-8 shapes of the main path,
   on inputs the real pipeline makes from real blocks, checks each
   bitwise against its plain PyTorch version on the card, and times both
   (CUDA events, median, in turns); K1 runs at the main path's chunk
   (``ops.mtf.CHUNK``) and again at chunk 64, the JAX pipeline's.  K2 and
   K3 are the whole functions of their TPU kernels: MTF indices to RLE2
   symbols (``rle2_expand_batch``) and payload entries to words
   (``pack_words_batch``).  K4 (stream compaction, on no path of the
   encoder) runs on the batch's flattened MTF indices and on three random
   masks at the same length, bitwise against its plain version.  Beside
   each kernel: its device time and kernel count per call
   (torch.profiler), its bound (bytes moved once at 3.35 TB/s, or its
   operations at 67 T/s, whichever is larger), its share of that bound,
   and the time of the nearest single PyTorch call (``library_ms``; none
   for K1), which the port never calls (for K2 ``repeat_interleave`` of
   the entries, the expansion half; for K3 ``index_add_`` of the word
   fields, the assembly half).  Then, at both dispatch shapes (batches of
   8 and 2), the profiler's kernel time and count of one ``mtf_indices``
   call (the chunk states' kernels and K1), and of one call of each of
   K2's and K3's functions;
4. compress: ``banzai_tpu_torch.compress(data, 9, device="cuda")`` through
   the overlapped block scheduler on about 8.6 MB built from the seed and
   the JAX package's source (read as bytes, never imported); the stream
   must equal the port's host encoder's byte for byte, decode with the
   standard library's bz2, and K1-K3 must have launched.  Then 7 timed
   runs, the peak device memory, one run under ``torch.profiler`` (device
   idle share) and one synchronised run (stage times);
5. encode: ``banzai_tpu_torch.encode`` on the same input in 3,000,000-byte
   spans (spans end inside blocks); same bytes as ``compress``;
6. CLI: ``python -m banzai_tpu_torch.cli -c -9 --device cuda <file>`` in
   a subprocess, exit 0 and the same bytes; then the CLI's ``main`` in
   this process, to count its launches;
7. hybrid: ``compress(..., hybrid_jobs=2)``, the same bytes, and at least
   one block encoded by a host worker;
8. parallel: block data parallelism, ``compress(..., device=["cuda:0"])``
   (one device thread) and ``device=["cuda:0", "cuda:0"]`` (two device
   threads on the one card), and with more than one card a list of every
   card, ``["cuda:0", "cuda:1", ...]``; each must give the
   same bytes, and its wall and batches per device thread are printed,
   then 5 timed runs of each in turns.  Then the multi-process encode:
   two ranks of ``python -m banzai_tpu_torch.parallel._worker`` in a gloo
   group on 127.0.0.1, rank r on ``cuda:{r % device count}`` (here both
   share the one card), through ``encode_multihost_path`` on the same
   input; rank 0's stream must equal ``compress``'s and decode with bz2,
   and each rank must have launched K1-K3.  Printed: the wall, each
   rank's start-up (spawn to group joined) split into the interpreter,
   the torch import, the card's context and kernel library, and the
   group's rendezvous, its encode, and the report;
9. spbwt: one block's BWT sharded lane-wise over D = 1, 2 and 4 shards,
   all on ``cuda:0`` (``parallel.spbwt.bwt_rotations_sharded``, a
   capability that no encode path calls), on two level-9 device blocks:
   the first, and the other one on which ``ops.bwt.bwt_rotations``
   needs the most doubling rounds (counted as its sorts; the sharded BWT
   at D = 1 must stop at the same coverage on every block).  Bytes and
   ``ptr`` must equal ``ops.bwt.bwt_rotations`` on the [1, N] row.
   Printed per D: the median wall of 3 calls, the rounds, the
   call's peak device memory and the largest tensor it made, in lanes.
   The machine has one card, so behaviour across cards is not checked.

Every path of phases 4-8 runs with the launch counts set to 0 just
before it and read just after (each rank counts in its own process),
and fails unless K1-K3 launched.  A launch is one call of a kernel's
entry point (K4's runs three kernels).  Each kernel's ``launches`` are
those of the compress run of phase 4, and ``launches_by_path`` those of
each path of phases 4, 8 and 9 (phase 9 launches none: its work is
``torch.sort``, scans and copies); K4's ``launches`` are those of its own
phase, its ``main_path_launches`` those of phase 4.  The line before the
last is the kernels' JSON; the last line is the result JSON.  Any
failure raises and exits non-zero.
"""

from __future__ import annotations

import argparse
import bz2
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

ROOT = Path(__file__).resolve().parent
LEVEL = 9
BATCH = 8
MAIN_KERNELS = ("mtf_shuffle", "rle2_expand", "pack_words")
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA's data sheet)
OPS_PER_S = 67e12           # H100 SXM 32-bit rate outside the tensor cores


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0]


def build_input(seed: int) -> bytes:
    """~8.6 MB: repository text, a correlated random walk, uniform random
    bytes, a 300 KB zero run and a period-5 run.

    The text is the JAX reference package's Python source, which the port
    leaves unchanged, so the input stays the same from commit to commit."""
    rng = np.random.default_rng(seed)
    files = sorted((ROOT / "banzai_tpu").glob("**/*.py"))
    corpus = b"".join(p.read_bytes() for p in files)
    if not corpus:
        raise RuntimeError("no banzai_tpu sources found beside chip_smoke.py")
    text = bytearray()
    while len(text) < 3_000_000:
        # Shifted slices of the corpus, so repeats are not whole-file.
        start = int(rng.integers(0, len(corpus)))
        text += corpus[start:] + corpus[:start]
    walk = (np.cumsum(rng.integers(-3, 4, 2_500_000)) & 0xFF).astype(np.uint8)
    uniform = rng.integers(0, 256, 2_500_000, dtype=np.uint8)
    return (
        bytes(text[:3_000_000]) + walk.tobytes() + uniform.tobytes()
        + b"\x00" * 300_000 + b"abcde" * 60_000
    )


def time_ms(fn, reps: int = 5) -> float:
    """Median ms of ``fn()`` over ``reps`` runs, by CUDA events."""
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def compare(name, kernel, plain, reps):
    """Run kernel and plain on the same inputs, require bitwise equality
    of every output (one tensor or a tuple), time both in turns (plain,
    kernel, kernel, plain)."""
    got = kernel()
    want = plain()
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = 0
    for g, w in zip(got, want, strict=True):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{name}: {g.shape}/{g.dtype} vs "
                                 f"{w.shape}/{w.dtype}")
        err = max(err, int((g.to(torch.int64) - w.to(torch.int64))
                           .abs().max()))
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"{name}: kernel disagrees with plain, "
                             f"max abs err {err}")
    p1 = time_ms(plain, reps)
    k1 = time_ms(kernel, reps)
    k2 = time_ms(kernel, reps)
    p2 = time_ms(plain, reps)
    return err, min(k1, k2), min(p1, p2)


def compare_compact(cases, kernel, plain, reps):
    """K4: for each (mask, payload) case, kernel and plain must agree on
    the count and bitwise on all lanes; times both in turns on the
    first case.  Returns (max abs err, kernel ms, plain ms)."""
    worst = 0
    for i, (mask, pay) in enumerate(cases):
        got, count = kernel(mask, pay)
        want, want_count = plain(mask, pay)
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        if int(count) != int(want_count) or not torch.equal(got, want):
            raise AssertionError(
                f"compact_stream case {i}: kernel disagrees with plain "
                f"(count {int(count)} vs {int(want_count)}, max abs err "
                f"{err})")
        worst = max(worst, err)
    mask, pay = cases[0]
    p1 = time_ms(lambda: plain(mask, pay), reps)
    k1 = time_ms(lambda: kernel(mask, pay), reps)
    k2 = time_ms(lambda: kernel(mask, pay), reps)
    p2 = time_ms(lambda: plain(mask, pay), reps)
    return worst, min(k1, k2), min(p1, p2)


def bound(nbytes: int, ops: int = 0) -> tuple[float, str]:
    """(least ms, "bytes" or "operations"): the larger of the bytes moved
    once over the memory rate and the operations over the peak rate."""
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    o_ms = ops / OPS_PER_S * 1e3
    return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def counted(name, fn):
    """Run ``fn`` with the launch counts set to 0 just before and read
    just after; raise unless every main-path kernel launched."""
    from banzai_tpu_torch import _build

    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    result = fn()
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    missing = [k for k in MAIN_KERNELS if launches.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"{name}: the path never launched {missing}")
    return result, launches


def trace(fn):
    """Run ``fn`` under torch.profiler; return (wall s, the trace's
    complete events)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"]
                      if e.get("ph") == "X"]
    return wall, events


def kernel_ms(fn, name: str = "", reps: int = 3):
    """Device time per call of ``fn`` under torch.profiler: (all its
    kernels' summed ms, the ms of those whose name holds ``name``, kernel
    count)."""
    _, events = trace(lambda: [fn() for _ in range(reps)])
    ks = [e for e in events if e.get("cat") == "kernel"]
    named = sum(e["dur"] for e in ks if name in e["name"])
    return (sum(e["dur"] for e in ks) / 1e3 / reps, named / 1e3 / reps,
            len(ks) // reps)


def kernel_split(fn, reps: int = 3) -> dict:
    """Device ms per call of ``fn`` under torch.profiler, by kernel (the
    ``*_kernel`` part of each name where it has one)."""
    _, events = trace(lambda: [fn() for _ in range(reps)])
    split: dict = {}
    for e in events:
        if e.get("cat") == "kernel":
            m = re.search(r"(\w+_kernel)\b", e["name"])
            key = m.group(1) if m else e["name"][:48]
            split[key] = split.get(key, 0.0) + e["dur"] / 1e3 / reps
    return split


def profile_busy(fn):
    """Run ``fn`` under torch.profiler; return (wall s, device busy ms as
    the union of kernel intervals, the same with copies and memsets
    added, kernel count)."""
    wall, events = trace(fn)

    def union_ms(cats):
        spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                       if e.get("ph") == "X" and e.get("cat") in cats)
        busy, end = 0.0, float("-inf")
        for a, b in spans:
            if b > end:
                busy += b - max(a, end)
                end = b
        return busy / 1e3, len(spans)

    kernels_ms, n_kernels = union_ms(("kernel",))
    all_ms, _ = union_ms(("kernel", "gpu_memcpy", "gpu_memset"))
    return wall, kernels_ms, all_ms, n_kernels


def parallel_phase(data: bytes, out: bytes) -> dict:
    """Phase 8: block data parallelism in this process, then two ranks of
    the multi-process encode.  Returns each path's launches."""
    import banzai_tpu_torch
    from banzai_tpu_torch.parallel._worker import run_ranks
    from banzai_tpu_torch.pipeline import EncodeStats

    ndev = torch.cuda.device_count()
    runs = {"dp1": ["cuda:0"], "dp2": ["cuda:0", "cuda:0"]}
    if ndev > 1:
        runs["dp_all"] = [f"cuda:{i}" for i in range(ndev)]
    launches_of = {}
    for label, devices in runs.items():
        stats = EncodeStats()
        t0 = time.perf_counter()
        got, launches = counted(label, lambda: banzai_tpu_torch.compress(
            data, LEVEL, device=devices, stats=stats))
        wall = time.perf_counter() - t0
        threads = len(devices)
        if got != out:
            raise AssertionError(f"{label}: stream differs from compress")
        if len(stats.device_batches) != threads:
            raise AssertionError(f"{label}: {stats.device_batches} batches "
                                 f"per thread, want {threads} threads")
        launches_of[label] = launches
        print(f"parallel {label} (device={devices!r}, "
              f"{threads} device threads): equal to compress; "
              f"{len(data) / wall / 1e6:.3f} MB/s wall ({wall:.3f} s); "
              f"batches per device thread {stats.device_batches}; launches "
              f"{launches}", flush=True)
    walls = {label: [] for label in runs}
    for _ in range(5):
        for label, devices in runs.items():
            t0 = time.perf_counter()
            banzai_tpu_torch.compress(data, LEVEL, device=devices)
            torch.cuda.synchronize()
            walls[label].append(time.perf_counter() - t0)
    med = {label: statistics.median(w) for label, w in walls.items()}
    print("parallel timing, 5 runs each in turns: " + "; ".join(
        f"{label} median {m:.4f} s = {len(data) / m / 1e6:.2f} MB/s "
        f"(min {min(walls[label]):.4f}, max {max(walls[label]):.4f} s)"
        for label, m in med.items()), flush=True)

    devices = [f"cuda:{r % ndev}" for r in range(2)]
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "smoke.bin")
        dst = os.path.join(tmp, "smoke.bin.bz2")
        rep = os.path.join(tmp, "report.json")
        with open(src, "wb") as f:
            f.write(data)
        t0 = time.perf_counter()
        lines = run_ranks(src, dst, LEVEL, devices, report_path=rep,
                          timeout=600)
        wall = time.perf_counter() - t0
        with open(dst, "rb") as f:
            got = f.read()
        with open(rep) as f:
            report = json.load(f)
    if got != out:
        raise AssertionError(f"2 ranks: rank 0's stream differs from "
                             f"compress ({len(got)} vs {len(out)} bytes)")
    if bz2.decompress(got) != data:
        raise AssertionError("2 ranks: bz2 round trip failed")
    for ln in lines:
        missing = [k for k in MAIN_KERNELS if ln["launches"].get(k, 0) <= 0]
        if missing:
            raise AssertionError(f"rank {ln['rank']} never launched "
                                 f"{missing}")
        launches_of[f"rank{ln['rank']}"] = ln["launches"]
    # Per rank, s: spawn to main (interpreter), main to torch imported,
    # to the card's context and kernel library, to the group joined (it
    # waits for the slowest rank), then the encode.
    steps = ("spawned", "main", "torch", "device", "group", "done")
    split = [{f"{a}-{b}": round(ln["at"][b] - ln["at"][a], 3)
              for a, b in zip(steps, steps[1:])} for ln in lines]
    startup = [round(ln["at"]["group"] - ln["at"]["spawned"], 3)
               for ln in lines]
    print(f"multi-process (2 ranks, gloo on 127.0.0.1, devices {devices}): "
          f"rank 0's stream equal to compress, bz2 round trip ok; wall "
          f"{wall:.3f} s from spawn to exit; start-up per rank (spawn to "
          f"group joined) {startup} s; steps per rank {json.dumps(split)}; "
          f"launches {[ln['launches'] for ln in lines]}; report "
          f"{json.dumps(report)}", flush=True)
    return launches_of


class SortCount(TorchDispatchMode):
    """Counts the sorts the operations run (ops/bwt: one a round)."""

    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.count += func.overloadpacket is torch.ops.aten.sort
        return func(*args, **(kwargs or {}))


class LargestTensor(TorchDispatchMode):
    """Records the numel of the largest tensor any operation makes."""

    def __init__(self):
        super().__init__()
        self.numel = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.numel = max(self.numel, t.numel())
        return out


def spbwt_phase(outputs: list[np.ndarray], N: int, dev: str) -> dict:
    """Phase 9: ``bwt_rotations_sharded`` at D = 1, 2 and 4 shards on
    ``dev`` against ``ops.bwt.bwt_rotations`` on two of the device blocks'
    RLE1 outputs.  Returns the launches of the sharded calls."""
    from banzai_tpu_torch import _build
    from banzai_tpu_torch.ops.bwt import bwt_rotations
    from banzai_tpu_torch.parallel.spbwt import bwt_rotations_sharded

    def padded(out: np.ndarray) -> torch.Tensor:
        block = np.zeros(N, np.uint8)
        block[: len(out)] = out
        return torch.from_numpy(block).to(dev)

    # Rounds per block of ops/bwt.bwt_rotations on its [1, N] row (one sort
    # a round); the sharded BWT at D = 1 must stop at the same k = 2^rounds.
    rounds = []
    for i, o in enumerate(outputs):
        with SortCount() as sorts:
            bwt_rotations(padded(o)[None], torch.tensor([len(o)]))
        rounds.append(sorts.count)
        k = bwt_rotations_sharded(padded(o), len(o), devices=[dev],
                                  debug_rounds=True)[2]
        if k != 1 << sorts.count:
            raise AssertionError(f"spbwt block {i} stops at k = {k}, ops.bwt "
                                 f"after {sorts.count} rounds")
    hard = max(range(1, len(outputs)), key=lambda i: rounds[i])
    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    for i, label in ((0, "first"), (hard, "most rounds")):
        block, n = padded(outputs[i]), len(outputs[i])
        want_bwt, want_ptr = bwt_rotations(block[None], torch.tensor([n]))
        want = (want_bwt[0, :n].cpu(), int(want_ptr[0]))
        for D in (1, 2, 4):
            devices = [dev] * D
            got, ptr, k = bwt_rotations_sharded(block, n, devices=devices,
                                                debug_rounds=True)
            if not (torch.equal(torch.cat(got)[:n].cpu(), want[0])
                    and int(ptr) == want[1]):
                raise AssertionError(f"spbwt block {i} at D = {D}: bytes or "
                                     f"ptr differ from ops.bwt")
            walls = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                bwt_rotations_sharded(block, n, devices=devices)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            bwt_rotations_sharded(block, n, devices=devices)
            peak = torch.cuda.max_memory_allocated() - base
            with LargestTensor() as largest:
                bwt_rotations_sharded(block, n, devices=devices)
            print(f"spbwt block {i} ({label}, n = {n}, N = {N}) D = {D} on "
                  f"{devices} (one card: across cards not verified): bytes "
                  f"and ptr equal to ops.bwt; wall median "
                  f"{statistics.median(walls):.4f} s of 3 (min "
                  f"{min(walls):.4f}, max {max(walls):.4f}); k = {k}, "
                  f"{k.bit_length() - 1} rounds (ops.bwt {rounds[i]}); "
                  f"peak device memory of the call {peak / 1e6:.1f} MB; "
                  f"largest tensor "
                  f"{largest.numel} lanes (shard m = {N // D})", flush=True)
    torch.cuda.synchronize()
    return dict(_build.LAUNCHES)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    # -- 1. card -----------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"card: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {kind}", flush=True)

    import banzai_tpu_torch
    from banzai_tpu_torch import _build, cli, pipeline
    from banzai_tpu_torch.block import unpack_rows
    from banzai_tpu_torch.ops.bitpack import block_payload_entries, splice_entries
    from banzai_tpu_torch.ops.bwt import bwt_rotations
    from banzai_tpu_torch.ops.compact_kernel import (
        compact_stream, compact_stream_plain,
    )
    from banzai_tpu_torch.ops.huffman import plan_entropy
    from banzai_tpu_torch.ops.mtf import CHUNK, mtf_indices, shuffle_inputs
    from banzai_tpu_torch.ops.mtf_kernel import mtf_shuffle, mtf_shuffle_plain
    from banzai_tpu_torch.ops.rle2 import rle2_entries
    from banzai_tpu_torch.ops.stream_kernels import (
        pack_words_batch, pack_words_batch_plain, rle2_expand_batch,
        rle2_expand_batch_plain,
    )
    from banzai_tpu_torch.pipeline import (
        EncodeStats, _nwords, _padded_len, stage_rows,
    )
    from banzai_tpu_torch.constants import SEGMENT_WIDTH
    from banzai_tpu_torch.encoder_host import TINY_BLOCK
    from banzai_tpu_torch.encoder_host import compress as host_compress
    from banzai_tpu_torch.rle1 import iter_blocks

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.3f} s "
          f"({', '.join(p.name for p in _build.sources())})", flush=True)

    # -- 3. kernels at the main path's shapes --------------------------------
    data = build_input(args.seed)
    blocks = list(iter_blocks(data, LEVEL))
    full = [b for b in blocks if len(b.output) > TINY_BLOCK]
    if len(full) < BATCH:
        raise AssertionError(f"only {len(full)} device blocks, need {BATCH}")
    N = _padded_len(LEVEL)
    nseg = (N + 1 + SEGMENT_WIDTH - 1) // SEGMENT_WIDTH
    nwords = _nwords(N, nseg)
    rows_h, _ = stage_rows([b.output for b in full[:BATCH]], N, BATCH)
    rows = rows_h.to(dev)
    blk, ns, present = unpack_rows(rows)
    bwt, _ = bwt_rotations(blk, ns)
    # K1 at the main path's chunk and at 64, the JAX pipeline's; the debug
    # build checks that every state stays a byte permutation.
    K = CHUNK
    k1_in = {k: shuffle_inputs(bwt, ns, present, k) for k in (K, 64)}
    for k1_syms, k1_state in k1_in.values():
        mtf_shuffle(k1_syms, k1_state, debug_checks=True)   # raises if corrupt
    k1_syms, k1_state = k1_in[K]

    def stream_inputs(bwt, ns, present):
        """K2's and K3's inputs as the main path makes them: (MTF
        indices, n, num_names) and the payload entry rows (vals, lens)."""
        num_names = present.sum(dim=1)
        idx = mtf_indices(bwt, ns, present)
        syms, out_len = rle2_expand_batch(idx, ns, num_names)
        plan = plan_entropy(syms, out_len, num_names + 2, nseg)
        vals, lens = block_payload_entries(
            syms, out_len, num_names + 2, plan["num_tables"],
            plan["tables"], plan["selectors"], plan["sel_mtf_idx"],
            plan["nseg_used"],
        )
        return (idx, ns, num_names), (vals, lens)

    k2_in, k3_in = stream_inputs(bwt, ns, present)
    idx = k2_in[0]
    syms, out_len = rle2_expand_batch(*k2_in)
    words, total = pack_words_batch(*k3_in, nwords)

    # Bounds from this run's inputs.  K1's operations depend on the data:
    # a symbol at list position i needs i + 1 compares and i moves.
    k1_out = mtf_shuffle(k1_syms, k1_state)
    k1_ops = int((2 * k1_out[k1_out >= 0].to(torch.int64) + 1).sum())
    k1_bound = bound(nbytes(k1_syms, k1_state, k1_out), k1_ops)
    # K2 reads the int32 indices and int64 n and num_names and writes the
    # symbols and out_len; K3 reads the int64 entry rows and writes the
    # words and the totals.
    k2_bound = bound(nbytes(*k2_in, syms, out_len))
    k3_bound = bound(nbytes(*k3_in, words, total))
    # The nearest single PyTorch calls (timed only; the port never calls
    # them), each on its half of the function's work, from the plain
    # versions' intermediates: K2 repeats each RLE2 entry's value by its
    # width (the expansion, from rle2_entries), K3 adds each entry's word
    # field into its word (the assembly, from splice_entries).
    ent = rle2_entries(*k2_in)
    k2_width = ent[1].reshape(-1).to(torch.int64)
    k2_val = ent[3].reshape(-1)
    k2_size = int(k2_width.sum())
    w, hi2, _ = splice_entries(*k3_in)
    k3_acc = torch.zeros(BATCH * (nwords + 1), dtype=torch.int64, device=dev)
    k3_idx = (torch.arange(BATCH, device=dev)[:, None] * (nwords + 1)
              + torch.clamp(w, max=nwords)).reshape(-1)
    k3_add = hi2.reshape(-1)
    cases = [
        ("mtf_shuffle", "banzai_tpu_torch/csrc/mtf_shuffle.cu",
         "banzai_tpu/ops/mtf_pallas.py:73",
         lambda: mtf_shuffle(k1_syms, k1_state),
         lambda: mtf_shuffle_plain(k1_syms, k1_state), None, k1_bound, 3),
        ("rle2_expand", "banzai_tpu_torch/csrc/rle2_expand.cu",
         "banzai_tpu/ops/stream_pallas.py:159",
         lambda: rle2_expand_batch(*k2_in),
         lambda: rle2_expand_batch_plain(*k2_in),
         lambda: torch.repeat_interleave(k2_val, k2_width,
                                         output_size=k2_size),
         k2_bound, 5),
        ("pack_words", "banzai_tpu_torch/csrc/pack_words.cu",
         "banzai_tpu/ops/stream_pallas.py:286",
         lambda: pack_words_batch(*k3_in, nwords),
         lambda: pack_words_batch_plain(*k3_in, nwords),
         lambda: k3_acc.index_add_(0, k3_idx, k3_add), k3_bound, 5),
    ]
    library_of = {"rle2_expand": "repeat_interleave of the RLE2 entries "
                                 "(the expansion half)",
                  "pack_words": "index_add_ of the word fields (the "
                                "assembly half)"}
    kernels = []
    for name, src, replaces, kern, plain, lib, (b_ms, b_by), reps in cases:
        err, ms, plain_ms = compare(name, kern, plain, reps)
        lib_ms = time_ms(lib, reps) if lib is not None else None
        dev_ms, _, per_call = kernel_ms(kern)
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": 0, "max_abs_err": err,
            "ms": ms, "device_ms": dev_ms, "kernels_per_call": per_call,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "share": b_ms / ms, "library_ms": lib_ms,
        })
        lib_txt = ("none" if lib_ms is None else
                   f"{lib_ms:.3f} ms ({library_of[name]})")
        print(f"kernel {name}: bitwise equal to plain; {ms:.3f} ms "
              f"(device {dev_ms:.3f} ms in {per_call} kernels) vs plain "
              f"{plain_ms:.3f} ms; bound {b_ms:.4f} ms by {b_by} (share "
              f"{b_ms / ms:.3f}); library call {lib_txt}", flush=True)
    print("history, not measured here (PERF.md section 6, the per-entry "
          "rows): the per-entry kernels the whole functions replace, K2 "
          "0.086 ms (device 0.060) after ~95 PyTorch passes of "
          "rle2_entries, K3 0.121 ms (device 0.050) after ~40 of "
          "splice_entries and casts", flush=True)
    k1 = kernels[0]
    k1["chunk"] = K
    s64, st64 = k1_in[64]
    err, ms, plain_ms = compare("mtf_shuffle at chunk 64",
                                lambda: mtf_shuffle(s64, st64),
                                lambda: mtf_shuffle_plain(s64, st64), 3)
    b_ms, b_by = bound(nbytes(s64, st64, s64), k1_ops)
    dev_ms = kernel_ms(lambda: mtf_shuffle(s64, st64))[0]
    k1["at_chunk_64"] = {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                         "bound_ms": b_ms, "bound_by": b_by,
                         "max_abs_err": err}
    print(f"kernel mtf_shuffle at chunk 64: bitwise equal to plain; "
          f"{ms:.3f} ms (device {dev_ms:.3f} ms) vs plain {plain_ms:.3f} ms; "
          f"bound {b_ms:.4f} ms by {b_by}", flush=True)
    shapes = (f"K1 syms {tuple(k1_syms.shape)} (chunk {K}; "
              f"{tuple(s64.shape)} at 64), K2 indices {tuple(idx.shape)} "
              f"-> symbols {tuple(syms.shape)}, K3 entries "
              f"{tuple(k3_in[0].shape)} -> words {tuple(words.shape)}")
    print(f"kernel shapes: {shapes}", flush=True)

    # K4: the batch's MTF indices flattened (mask idx != 0, payload idx),
    # then random masks of densities 0, 0.05 and 1 at the same length.
    flat = idx.reshape(-1).contiguous()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    k4_cases = [(flat != 0, flat)] + [
        (torch.rand(flat.shape, generator=gen, device=dev) < d, flat)
        for d in (0.0, 0.05, 1.0)
    ]
    _build.LAUNCHES.clear()
    err, ms, plain_ms = compare_compact(k4_cases, compact_stream,
                                        compact_stream_plain, 5)
    own_launches = _build.LAUNCHES["compact_stream"]
    k4_mask = k4_cases[0][0]
    lib_ms = time_ms(lambda: torch.masked_select(flat, k4_mask), 5)
    dev_ms = kernel_ms(lambda: compact_stream(k4_mask, flat))[0]
    b_ms, b_by = bound(nbytes(k4_mask, flat, flat) + 8)
    kept = [int(m.sum()) for m, _ in k4_cases]
    kernels.append({
        "name": "compact_stream", "route": "cuda",
        "source": "banzai_tpu_torch/csrc/compact_stream.cu",
        "replaces": "banzai_tpu/ops/compact_pallas.py:97",
        "launches": own_launches,
        "launches_counted_in": "its own phase: K4 is on no path of the "
                               "encoder, as in the JAX package",
        "main_path_launches": None,   # read from the compress phase below
        "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
        "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "share": b_ms / ms, "library_ms": lib_ms,
    })
    print(f"kernel compact_stream: bitwise equal to plain with equal "
          f"counts on {len(k4_cases)} masks over {flat.numel()} lanes "
          f"(kept {kept}); {ms:.3f} ms (device {dev_ms:.3f} ms) vs plain "
          f"{plain_ms:.3f} ms "
          f"(real-index mask); bound {b_ms:.4f} ms by {b_by} (share "
          f"{b_ms / ms:.3f}); library call {lib_ms:.3f} ms", flush=True)

    # The MTF stage's kernels (chunk states + K1), and K2's and K3's
    # functions, at the scheduler's two dispatch shapes: the full batch
    # and the quarter batch of 2.
    mtf_shapes = {BATCH: (bwt, ns, present)}
    q = max(1, BATCH // 4)
    q_rows, _ = stage_rows([b.output for b in full[:q]], N, q)
    q_blk, q_ns, q_present = unpack_rows(q_rows.to(dev))
    mtf_shapes[q] = (bwt_rotations(q_blk, q_ns)[0], q_ns, q_present)
    stream_shapes = {BATCH: (k2_in, k3_in),
                     q: stream_inputs(*mtf_shapes[q])}
    mtf_stage, stream_fns = {}, {}
    for B, margs in sorted(mtf_shapes.items()):
        wall_ms = time_ms(lambda: mtf_indices(*margs), 5)
        k_ms, k1_ms, n_k = kernel_ms(lambda: mtf_indices(*margs),
                                     "mtf_shuffle")
        mtf_stage[B] = {"chunk": CHUNK, "ms": wall_ms,
                        "kernel_ms": k_ms, "k1_ms": k1_ms, "kernels": n_k}
        s2, s3 = stream_shapes[B]
        fns = {"rle2_expand_batch": lambda: rle2_expand_batch(*s2),
               "pack_words_batch": lambda: pack_words_batch(*s3, nwords)}
        stream_fns[B] = {}
        for fname, fn in fns.items():
            wall_ms = time_ms(fn, 5)
            k_ms, _, n_k = kernel_ms(fn)
            stream_fns[B][fname] = {"ms": wall_ms, "kernel_ms": k_ms,
                                    "kernels": n_k,
                                    "by_kernel_ms": kernel_split(fn)}
            if n_k > 4:
                raise AssertionError(f"{fname} at batch {B}: {n_k} "
                                     f"kernels per call, more than 4")
    print(f"mtf stage (mtf_indices; kernel ms = the profiler's sum of the "
          f"chunk states' kernels and K1, per call): "
          f"{json.dumps(mtf_stage)}", flush=True)
    print(f"rle2 and pack functions (one call each; kernel ms and kernels "
          f"= the profiler's sum and count per call, by_kernel_ms its split): "
          f"{json.dumps(stream_fns)}", flush=True)
    del rows, blk, bwt, idx, ent, syms, out_len, k1_in, k1_out, k2_in, k3_in
    del w, hi2, words, total, k1_syms, k1_state, s64, st64, flat
    del k4_cases, k4_mask, k2_width, k2_val, k3_acc, k3_idx, k3_add
    del mtf_shapes, stream_shapes, q_rows, q_blk, q_ns, q_present, margs
    del s2, s3, fns, fn

    # -- 4. compress through the overlapped scheduler ------------------------
    banzai_tpu_torch.compress(data[:2_000_000], LEVEL, device="cuda")  # warm
    stats = EncodeStats()
    t0 = time.perf_counter()
    out, launches = counted("compress", lambda: banzai_tpu_torch.compress(
        data, LEVEL, device="cuda", stats=stats))
    wall = time.perf_counter() - t0
    path_launches = {"compress": launches}
    for k in kernels:
        if k["name"] in MAIN_KERNELS:
            k["launches"] = launches[k["name"]]
        else:
            k["main_path_launches"] = launches.get(k["name"], 0)

    ref = host_compress(data, LEVEL, jobs=1)
    if out != ref:
        raise AssertionError(
            f"stream differs from the host encoder ({len(out)} vs "
            f"{len(ref)} bytes)"
        )
    if bz2.decompress(out) != data:
        raise AssertionError("bz2 round trip failed")
    if stats.device_blocks != len(full) or stats.host_capacity:
        raise AssertionError(f"not every non-tiny block went through the "
                             f"device path: {stats}")
    print(f"compress: {len(data)} B -> {len(out)} B, "
          f"{len(data) / wall / 1e6:.3f} MB/s wall ({wall:.3f} s), "
          f"{stats.batches} batches, device blocks {stats.device_blocks}, "
          f"host tiny {stats.host_tiny}, host capacity "
          f"{stats.host_capacity}, host banzai {stats.host_banzai}, "
          f"refetches {stats.refetches}; equal to host encoder, bz2 round "
          f"trip ok; launches {launches}", flush=True)

    walls = []
    for _ in range(7):
        t0 = time.perf_counter()
        banzai_tpu_torch.compress(data, LEVEL, device="cuda")
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    q1, med, q3 = statistics.quantiles(walls, n=4)
    torch.cuda.reset_peak_memory_stats()
    timed = EncodeStats()
    banzai_tpu_torch.compress(data, LEVEL, device="cuda", stats=timed)
    peak = torch.cuda.max_memory_allocated()
    host_ms = {k: round(v, 3) for k, v in timed.host_ms.items()}
    print(f"compress timing: median {med:.4f} s = "
          f"{len(data) / med / 1e6:.2f} MB/s over 7 runs (quartiles "
          f"{q1:.4f}-{q3:.4f} s); peak device memory {peak / 1e9:.3f} GB; "
          f"host step ms (summed per thread, one run) {json.dumps(host_ms)}",
          flush=True)
    pwall, busy_k, busy_all, n_k = profile_busy(
        lambda: banzai_tpu_torch.compress(data, LEVEL, device="cuda"))
    print(f"compress profile: {pwall * 1e3:.1f} ms wall; kernels busy "
          f"{busy_k:.1f} ms in {n_k} kernels (idle share "
          f"{100 * (1 - busy_k / 1e3 / pwall):.1f} %); with copies "
          f"{busy_all:.1f} ms (idle share "
          f"{100 * (1 - busy_all / 1e3 / pwall):.1f} %)", flush=True)
    staged = EncodeStats(stage_ms={})
    banzai_tpu_torch.compress(data, LEVEL, device="cuda", stats=staged)
    stage_ms = {k: round(v, 3) for k, v in staged.stage_ms.items()}
    print(f"stage ms (synchronised run): {json.dumps(stage_ms)}", flush=True)

    # -- 5. streaming encode --------------------------------------------------
    sink = io.BytesIO()
    t0 = time.perf_counter()
    n, launches = counted("encode", lambda: banzai_tpu_torch.encode(
        io.BytesIO(data), sink, LEVEL, device="cuda", span_bytes=3_000_000))
    ewall = time.perf_counter() - t0
    if sink.getvalue() != out or n != len(out):
        raise AssertionError(f"encode wrote {n} B, not the compress stream")
    print(f"encode (3,000,000-byte spans): {n} B, equal to compress; "
          f"{len(data) / ewall / 1e6:.3f} MB/s wall ({ewall:.3f} s); "
          f"launches {launches}", flush=True)

    # -- 6. the CLI -------------------------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "smoke.bin")
        with open(src, "wb") as f:
            f.write(data)
        env = dict(os.environ, PYTHONPATH=str(ROOT))
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "banzai_tpu_torch.cli", "-c", f"-{LEVEL}",
             "--device", "cuda", src],
            cwd=ROOT, env=env, capture_output=True, timeout=600,
        )
        cwall = time.perf_counter() - t0
        if res.returncode != 0:
            raise AssertionError(f"CLI exited {res.returncode}: "
                                 f"{res.stderr.decode()[-2000:]}")
        if res.stdout != out:
            raise AssertionError("CLI stream differs from compress")
        dst = os.path.join(tmp, "smoke.bin.bz2")
        rc, launches = counted("CLI main", lambda: cli.main(
            ["-k", f"-{LEVEL}", "--device", "cuda", src]))
        with open(dst, "rb") as f:
            if rc != 0 or f.read() != out:
                raise AssertionError(f"CLI main exited {rc} or wrote "
                                     f"another stream")
    print(f"cli: python -m banzai_tpu_torch.cli -c -{LEVEL} --device cuda "
          f"exit 0, equal to compress ({cwall:.3f} s with interpreter start); "
          f"in-process main launches {launches}", flush=True)

    # -- 7. hybrid host stealing ----------------------------------------------
    hstats = EncodeStats()
    t0 = time.perf_counter()
    hout, launches = counted("hybrid", lambda: banzai_tpu_torch.compress(
        data, LEVEL, device="cuda", stats=hstats, hybrid_jobs=2))
    hwall = time.perf_counter() - t0
    pipeline._shutdown_hybrid_pool()
    if hout != out:
        raise AssertionError("hybrid_jobs=2 stream differs from compress")
    if hstats.host_hybrid < 1:
        raise AssertionError(f"no block was stolen by a host worker: "
                             f"{hstats}")
    print(f"hybrid (2 host workers): equal to compress; "
          f"{hstats.host_hybrid} blocks stolen, {hstats.device_blocks} on "
          f"the device; {hwall:.3f} s with the workers' start; launches "
          f"{launches}", flush=True)

    # -- 8. parallel ----------------------------------------------------------
    path_launches.update(parallel_phase(data, out))

    # -- 9. spbwt: one block's BWT over D shards ------------------------------
    path_launches["spbwt"] = spbwt_phase([b.output for b in full], N,
                                         "cuda:0")
    for k in kernels:
        k["launches_by_path"] = {p: n.get(k["name"], 0)
                                 for p, n in path_launches.items()}
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
