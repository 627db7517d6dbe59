"""Time banzai_tpu_torch's MTF stage on one CUDA card.

    python3 tools/torch_mtf_chunks.py sweep [--seed N] [--out FILE]
    python3 tools/torch_mtf_chunks.py turns --parent DIR [--seed N] [--out FILE]

Both modes use the level-9 smoke input of ``chip_smoke.py`` (``--seed``,
default 0) and the scheduler's two dispatch shapes: a quarter batch of 2
blocks and a full batch of 8, each the first blocks of the input after a
BWT on the card.

``sweep`` times this tree's ``ops.mtf.mtf_indices`` (chunk states + K1)
at every chunk from 64 to 2048, after checking each output bitwise
against chunk 64's: wall ms by CUDA events (median of 20 after 2
warm-ups), then the summed kernel time of 3 calls under torch.profiler,
all kernels and K1's alone.  ``ops.mtf.CHUNK`` is the chunk with the
least time at both shapes.

``turns`` measures this tree and the tree at DIR (an unpacked checkout of
another commit, with its own ``banzai_tpu_torch`` and whatever that
imports) in turns, DIR, this, this, DIR, each in a fresh process:
``mtf_indices`` at each tree's own default chunk as above, and
``compress`` of the whole input at level 9 (median wall of 7 runs after a
warm-up, peak device memory, the stage times of one synchronised run, and
the kernel count, busy time and idle share of one run under
torch.profiler).

Every result is one JSON line on stdout (and in ``--out``), beside the
card's name and power limit from nvidia-smi.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CHUNKS = (64, 128, 256, 512, 1024, 2048)
BATCHES = (2, 8)


def _smoke():
    """``chip_smoke.py`` of this tree, loaded as a module (its input,
    card line and timers)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def measure(tree: Path, seed: int, chunks, with_compress: bool):
    """Yield one result dict per (batch, chunk) for the tree at ``tree``,
    then one for ``compress`` when ``with_compress``.  ``chunks`` holds
    None for the tree's own default."""
    sys.path.insert(0, str(tree))
    import torch

    import banzai_tpu_torch
    from banzai_tpu_torch import pipeline
    from banzai_tpu_torch.block import unpack_rows
    from banzai_tpu_torch.ops import mtf as mtf_mod
    from banzai_tpu_torch.ops.bwt import bwt_rotations
    from banzai_tpu_torch.pipeline import (
        TINY_BLOCK, _padded_len, iter_blocks, stage_rows,
    )

    assert Path(banzai_tpu_torch.__file__).resolve().is_relative_to(
        tree.resolve()), banzai_tpu_torch.__file__
    smoke = _smoke()
    data = smoke.build_input(seed)
    full = [b.output for b in iter_blocks(data, 9)
            if len(b.output) > TINY_BLOCK]
    N = _padded_len(9)
    for B in BATCHES:
        rows_h, _ = stage_rows(full[:B], N, B)
        blk, ns, present = unpack_rows(rows_h.cuda())
        bwt, _ = bwt_rotations(blk, ns)
        ref = None
        for chunk in chunks:
            args = (bwt, ns, present) + (() if chunk is None else (chunk,))

            def fn():
                return mtf_mod.mtf_indices(*args)

            got = fn()
            if ref is None:
                ref = got
            elif not torch.equal(got, ref):
                raise AssertionError(f"batch {B}: chunk {chunk} differs from "
                                     f"chunk {chunks[0]}")
            for _ in range(2):                  # warm-up
                fn()
            ms = smoke.time_ms(fn, 20)
            k_ms, k1_ms, n_k = smoke.kernel_ms(fn, "mtf_shuffle")
            yield {"tree": str(tree), "batch": B, "chunk": chunk,
                   "mtf_ms": ms, "kernel_ms": k_ms, "k1_ms": k1_ms,
                   "kernels": n_k}
        del blk, bwt, ns, present, ref
    if with_compress:
        banzai_tpu_torch.compress(data[:2_000_000], 9, device="cuda")
        walls = []
        for _ in range(7):
            t0 = time.perf_counter()
            banzai_tpu_torch.compress(data, 9, device="cuda")
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        torch.cuda.reset_peak_memory_stats()
        banzai_tpu_torch.compress(data, 9, device="cuda")
        peak = torch.cuda.max_memory_allocated()
        staged = pipeline.EncodeStats(stage_ms={})
        banzai_tpu_torch.compress(data, 9, device="cuda", stats=staged)
        pwall, busy_ms, _, n_kernels = smoke.profile_busy(
            lambda: banzai_tpu_torch.compress(data, 9, device="cuda"))
        q1, med, q3 = statistics.quantiles(walls, n=4)
        yield {"tree": str(tree), "compress_s": med, "quartiles_s": [q1, q3],
               "mb_s": len(data) / med / 1e6, "peak_gb": peak / 1e9,
               "stage_ms": staged.stage_ms, "profiled_wall_ms": pwall * 1e3,
               "kernels": n_kernels, "kernels_busy_ms": busy_ms,
               "idle_share": 1 - busy_ms / 1e3 / pwall}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("mode", choices=("sweep", "turns", "_worker"))
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--tree", type=Path, default=ROOT)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_mtf_chunks: no CUDA device", file=sys.stderr)
        return 1
    out = open(args.out, "a") if args.out else None

    def emit(rec: dict) -> None:
        line = json.dumps(rec)
        print(line, flush=True)
        if out is not None:
            out.write(line + "\n")
            out.flush()

    if args.mode == "_worker":
        for rec in measure(args.tree, args.seed, (None,), True):
            emit(rec)
        return 0
    emit({"card": _smoke().card_line(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "mode": args.mode})
    if args.mode == "sweep":
        for rec in measure(ROOT, args.seed, CHUNKS, False):
            emit(rec)
        return 0
    if args.parent is None:
        ap.error("turns needs --parent")
    parent = args.parent.resolve()
    for tree in (parent, ROOT, ROOT, parent):
        res = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "_worker",
             "--tree", str(tree), "--seed", str(args.seed)],
            capture_output=True, text=True, timeout=900, cwd=tree,
        )
        if res.returncode != 0:
            raise RuntimeError(f"worker on {tree} exited {res.returncode}: "
                               f"{res.stderr[-3000:]}")
        for line in res.stdout.splitlines():
            emit(dict(json.loads(line), turn_of=str(tree)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
