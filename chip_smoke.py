"""Smoke run of banzai_tpu_torch on one CUDA card.

    python3 chip_smoke.py [--seed N]

Phases, one line each:

1. card: the card's name and power limit (nvidia-smi); exits non-zero
   when there is no CUDA device;
2. build: compiles the CUDA kernels from ``banzai_tpu_torch/csrc``;
3. kernels: runs each kernel at the level-9, batch-8 shapes of the main
   path, on inputs the real pipeline makes from real blocks, checks it
   bitwise against its plain PyTorch version on the card, and times both
   (CUDA events, median, in turns);
4. end to end: ``banzai_tpu_torch.compress(data, 9, device="cuda")`` on
   about 8 MB built from the seed and the repository's own text; the
   stream must equal the host encoder's byte for byte, decode with the
   standard library's bz2, and every kernel must have launched.

The line before the last is the kernels' JSON; the last line is the
result JSON.  Any failure raises and exits non-zero.
"""

from __future__ import annotations

import argparse
import bz2
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
LEVEL = 9
BATCH = 8


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
    from banzai_tpu_torch import _build
    from banzai_tpu_torch.block import unpack_rows
    from banzai_tpu_torch.ops.bitpack import block_payload_entries, splice_entries
    from banzai_tpu_torch.ops.bwt import bwt_rotations
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
    arr, _ = stage_rows([b.output for b in full[:BATCH]], N, BATCH)
    rows = torch.from_numpy(arr).to(dev)
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
    del rows, blk, bwt, syms_c, state0, idx, ent, syms, plan, vals, lens
    del w, hi2, total, k3_w, k3_h, k3_t, k1_syms, k1_state

    # -- 4. end to end -----------------------------------------------------
    banzai_tpu_torch.compress(data[:2_000_000], LEVEL, device="cuda")  # warm
    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    stats = EncodeStats()
    t0 = time.perf_counter()
    out = banzai_tpu_torch.compress(data, LEVEL, device="cuda", stats=stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    for k in kernels:
        k["launches"] = launches.get(k["name"], 0)
        if k["launches"] <= 0:
            raise AssertionError(f"main path never launched {k['name']}")

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
    timed = EncodeStats(stage_ms={})
    banzai_tpu_torch.compress(data, LEVEL, device="cuda", stats=timed)
    stage_ms = {k: round(v, 3) for k, v in timed.stage_ms.items()}
    print(f"end to end: {len(data)} B -> {len(out)} B, "
          f"{len(data) / wall / 1e6:.3f} MB/s wall ({wall:.3f} s), "
          f"{stats.batches} batches, device blocks {stats.device_blocks}, "
          f"host tiny {stats.host_tiny}, host capacity "
          f"{stats.host_capacity}, host banzai {stats.host_banzai}; "
          f"equal to host encoder, bz2 round trip ok; launches {launches}",
          flush=True)
    print(f"stage ms (synchronised run): {json.dumps(stage_ms)}", flush=True)
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
