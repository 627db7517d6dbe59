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
   (CUDA events, median, in turns); K4 (stream compaction, on no path of
   the encoder) runs on the batch's flattened MTF indices and on three
   random masks at the same length, bitwise against its plain version;
4. compress: ``banzai_tpu_torch.compress(data, 9, device="cuda")`` through
   the overlapped block scheduler on about 8.6 MB built from the seed and
   the JAX package's source; the stream must equal the host encoder's
   byte for byte, decode with the standard library's bz2, and K1-K3 must
   have launched.  Then 7 timed runs, the peak device memory, one run
   under ``torch.profiler`` (device idle share) and one synchronised run
   (stage times);
5. encode: ``banzai_tpu_torch.encode`` on the same input in 3,000,000-byte
   spans (spans end inside blocks); same bytes as ``compress``;
6. CLI: ``python -m banzai_tpu_torch.cli -c -9 --device cuda <file>`` in
   a subprocess, exit 0 and the same bytes; then the CLI's ``main`` in
   this process, to count its launches;
7. hybrid: ``compress(..., hybrid_jobs=2)``, the same bytes, and at least
   one block encoded by a host worker.

Every path of phases 4-7 runs with the launch counts set to 0 just
before it and read just after, and fails unless K1-K3 launched.  The
line before the last is the kernels' JSON; the last line is the result
JSON.  Any failure raises and exits non-zero.
"""

from __future__ import annotations

import argparse
import bz2
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
LEVEL = 9
BATCH = 8
MAIN_KERNELS = ("mtf_shuffle", "rle2_expand", "pack_words")


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
    """Run kernel and plain on the same inputs, require bitwise equality,
    time both in turns (plain, kernel, kernel, plain)."""
    got = kernel()
    want = plain()
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: {got.shape}/{got.dtype} vs "
                             f"{want.shape}/{want.dtype}")
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    if not torch.equal(got, want):
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


def profile_busy(fn):
    """Run ``fn`` under torch.profiler; return (wall s, device busy ms as
    the union of kernel intervals, the same with copies and memsets
    added, kernel count)."""
    from torch.profiler import ProfilerActivity, profile

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
            events = json.load(f)["traceEvents"]

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
    from banzai_tpu.encoder_host import compress as host_compress
    from banzai_tpu.rle1 import iter_blocks
    from banzai_tpu_torch import _build, cli, pipeline
    from banzai_tpu_torch.block import unpack_rows
    from banzai_tpu_torch.ops.bitpack import block_payload_entries, splice_entries
    from banzai_tpu_torch.ops.bwt import bwt_rotations
    from banzai_tpu_torch.ops.compact_kernel import (
        compact_stream, compact_stream_plain,
    )
    from banzai_tpu_torch.ops.huffman import plan_entropy
    from banzai_tpu_torch.ops.mtf import chunk_states, mtf_indices
    from banzai_tpu_torch.ops.mtf_kernel import mtf_shuffle, mtf_shuffle_plain
    from banzai_tpu_torch.ops.rle2 import rle2_entries
    from banzai_tpu_torch.ops.stream_kernels import (
        as_int32_bits, pack_words, pack_words_plain, rle2_expand,
        rle2_expand_plain,
    )
    from banzai_tpu_torch.pipeline import (
        EncodeStats, _CHUNK, _nwords, _padded_len, stage_rows,
    )
    from banzai_tpu.constants import SEGMENT_WIDTH
    from banzai_tpu.encoder_host import TINY_BLOCK

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
    num_names = present.sum(dim=1)
    bwt, _ = bwt_rotations(blk, ns)
    pos = torch.arange(N, device=dev)[None, :]
    syms_c = torch.where(pos < ns[:, None], bwt.to(torch.int32), -1)
    state0 = chunk_states(syms_c, present, _CHUNK)
    C = BATCH * (N // _CHUNK)
    k1_syms = syms_c.reshape(C, _CHUNK)
    k1_state = state0.reshape(C, 256)
    mtf_shuffle(k1_syms, k1_state, debug_checks=True)   # raises if corrupt
    idx = mtf_indices(bwt, ns, present, _CHUNK)
    ent = rle2_entries(idx, ns, num_names)
    syms = rle2_expand(*ent)
    plan = plan_entropy(syms, ent[4], num_names + 2, nseg)
    vals, lens = block_payload_entries(
        syms, ent[4], num_names + 2, plan["num_tables"], plan["tables"],
        plan["selectors"], plan["sel_mtf_idx"], plan["nseg_used"],
    )
    w, hi2, total = splice_entries(vals, lens)
    k3_w = torch.clamp(w, max=nwords).to(torch.int32).contiguous()
    k3_h = as_int32_bits(hi2).contiguous()
    k3_t = total.to(torch.int32)

    cases = [
        ("mtf_shuffle", "banzai_tpu_torch/csrc/mtf_shuffle.cu",
         "banzai_tpu/ops/mtf_pallas.py:73",
         lambda: mtf_shuffle(k1_syms, k1_state),
         lambda: mtf_shuffle_plain(k1_syms, k1_state), 3),
        ("rle2_expand", "banzai_tpu_torch/csrc/rle2_expand.cu",
         "banzai_tpu/ops/stream_pallas.py:159",
         lambda: rle2_expand(*ent), lambda: rle2_expand_plain(*ent), 5),
        ("pack_words", "banzai_tpu_torch/csrc/pack_words.cu",
         "banzai_tpu/ops/stream_pallas.py:286",
         lambda: pack_words(k3_w, k3_h, k3_t, nwords),
         lambda: pack_words_plain(k3_w, k3_h, k3_t, nwords), 5),
    ]
    kernels = []
    for name, src, replaces, kern, plain, reps in cases:
        err, ms, plain_ms = compare(name, kern, plain, reps)
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": 0, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms,
        })
        print(f"kernel {name}: bitwise equal to plain; {ms:.3f} ms vs "
              f"plain {plain_ms:.3f} ms", flush=True)
    shapes = (f"K1 syms {tuple(k1_syms.shape)}, K2 entries "
              f"{tuple(ent[0].shape)}, K3 entries {tuple(k3_w.shape)} "
              f"-> words [{BATCH}, {nwords}]")
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
    kept = [int(m.sum()) for m, _ in k4_cases]
    kernels.append({
        "name": "compact_stream", "route": "cuda",
        "source": "banzai_tpu_torch/csrc/compact_stream.cu",
        "replaces": "banzai_tpu/ops/compact_pallas.py:97",
        "launches": _build.LAUNCHES["compact_stream"],
        "launches_counted_in": "its own phase: K4 is on no path of the "
                               "encoder, as in the JAX package",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
    })
    print(f"kernel compact_stream: bitwise equal to plain with equal "
          f"counts on {len(k4_cases)} masks over {flat.numel()} lanes "
          f"(kept {kept}); {ms:.3f} ms vs plain {plain_ms:.3f} ms "
          f"(real-index mask)", flush=True)
    del rows, blk, bwt, syms_c, state0, idx, ent, syms, plan, vals, lens
    del w, hi2, total, k3_w, k3_h, k3_t, k1_syms, k1_state, flat, k4_cases

    # -- 4. compress through the overlapped scheduler ------------------------
    banzai_tpu_torch.compress(data[:2_000_000], LEVEL, device="cuda")  # warm
    stats = EncodeStats()
    t0 = time.perf_counter()
    out, launches = counted("compress", lambda: banzai_tpu_torch.compress(
        data, LEVEL, device="cuda", stats=stats))
    wall = time.perf_counter() - t0
    for k in kernels:
        if k["name"] in MAIN_KERNELS:
            k["launches"] = launches[k["name"]]

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
            [sys.executable, "-m", "banzai_tpu_torch.cli", "-c", "-9",
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
            ["-k", "-9", "--device", "cuda", src]))
        with open(dst, "rb") as f:
            if rc != 0 or f.read() != out:
                raise AssertionError(f"CLI main exited {rc} or wrote "
                                     f"another stream")
    print(f"cli: python -m banzai_tpu_torch.cli -c -9 --device cuda exit 0, "
          f"equal to compress ({cwall:.3f} s with interpreter start); "
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
