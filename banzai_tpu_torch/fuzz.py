"""Differential fuzz driver of the port: ``python -m banzai_tpu_torch.fuzz``.

Counterpart of the repository's root ``fuzz.py``: deterministic random
inputs (structured generations, and mutations of a corpus) are encoded
with ``banzai_tpu_torch.compress`` on ``--device`` and must equal the
port's host encoder ``encoder_host.compress`` byte for byte and decode
with the standard library's ``bz2``.  A failing input is written to
``fuzz_fail.bin`` in the working directory.

    python -m banzai_tpu_torch.fuzz [iterations] [--seed S]
        [--device cuda|cpu] [--level L] [--corpus DIR]
"""

from __future__ import annotations

import argparse
import bz2
import glob
import os
import random
import sys


def gen_case(rng: random.Random) -> bytes:
    """Structured generator: mixes literals, runs, periodic repeats."""
    kind = rng.randrange(6)
    n = rng.choice([0, 1, 2, 3, 7, 100, 1000, 10_000, 120_000])
    if kind == 0:
        return rng.randbytes(n)
    if kind == 1:
        alpha = rng.choice([1, 2, 3, 16])
        return bytes(rng.randrange(alpha) for _ in range(n))
    if kind == 2:                      # run soup
        parts, tot = [], 0
        while tot < n:
            ln = rng.choice([1, 2, 3, 4, 5, 250, 251, 255, 256, 259, 260])
            parts.append(bytes([rng.randrange(8)]) * ln)
            tot += ln
        return b"".join(parts)
    if kind == 3:                      # periodic
        period = rng.randrange(1, 12)
        seed = rng.randbytes(period)
        return (seed * (n // max(1, period) + 1))[:n]
    if kind == 4:                      # text-ish
        words = [rng.randbytes(rng.randrange(2, 9)) for _ in range(16)]
        out = bytearray()
        while len(out) < n:
            out += rng.choice(words) + b" "
        return bytes(out[:n])
    return rng.randbytes(rng.randrange(0, 300))


def mutate(rng: random.Random, pool: list[bytes]) -> bytes:
    """One to three mutations of a random corpus entry, aimed at the
    encoder's data-dependent seams: RLE1 run boundaries, block-capacity
    edges, periodic regions."""
    data = bytearray(rng.choice(pool))
    for _ in range(rng.randrange(1, 4)):
        op = rng.randrange(7)
        if op == 0 and data:                      # byte flips
            for _ in range(rng.randrange(1, 8)):
                data[rng.randrange(len(data))] = rng.randrange(256)
        elif op == 1:                             # splice another entry
            other = rng.choice(pool)
            if other:
                i = rng.randrange(len(other))
                j = rng.randrange(i, min(len(other), i + 4096))
                at = rng.randrange(len(data) + 1)
                data[at:at] = other[i:j]
        elif op == 2 and data:                    # repeat-expand a slice
            i = rng.randrange(len(data))
            j = rng.randrange(i, min(len(data), i + 64))
            data[i:i] = bytes(data[i:j]) * rng.randrange(2, 40)
        elif op == 3:                             # insert a run
            at = rng.randrange(len(data) + 1)
            ln = rng.choice([3, 4, 5, 250, 251, 255, 256, 259, 260, 1000])
            data[at:at] = bytes([rng.randrange(256)]) * ln
        elif op == 4:                             # insert periodic chunk
            at = rng.randrange(len(data) + 1)
            p = rng.randbytes(rng.randrange(1, 9))
            data[at:at] = p * rng.randrange(4, 200)
        elif op == 5 and len(data) > 1:           # truncate / delete
            i = rng.randrange(len(data))
            j = rng.randrange(i, len(data))
            del data[i:j]
        else:                                     # duplicate whole input
            if len(data) < 400_000:
                data = data + data
    return bytes(data[:2_000_000])


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("iterations", nargs="?", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument(
        "--level", type=int, default=1,
        help="compression level 1-9, or 0 to draw a random level per case",
    )
    ap.add_argument(
        "--corpus",
        default=os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "tests", "corpus"),
        help="mutation corpus dir ('' disables the mutation loop)",
    )
    args = ap.parse_args(argv)

    from .encoder_host import compress as host_compress

    from . import compress

    pool: list[bytes] = []
    if args.corpus and os.path.isdir(args.corpus):
        for p in sorted(glob.glob(os.path.join(args.corpus, "*.bin"))):
            with open(p, "rb") as f:
                pool.append(f.read())

    rng = random.Random(args.seed)
    for i in range(args.iterations):
        data = mutate(rng, pool) if pool and rng.random() < 0.5 else (
            gen_case(rng)
        )
        level = args.level or rng.randrange(1, 10)
        out = compress(data, level, device=args.device)
        why = None
        if out != host_compress(data, level, jobs=1):
            why = "stream differs from the host encoder"
        elif bz2.decompress(out) != data:
            why = "bz2 round trip failed"
        if why:
            with open("fuzz_fail.bin", "wb") as f:
                f.write(data)
            print(f"FAIL @ iter {i}: {why}: {len(data)} bytes at level "
                  f"{level} (seed {args.seed}); saved to fuzz_fail.bin",
                  file=sys.stderr)
            return 1
        if i % 10 == 0:
            print(f"iter {i}: {len(data):7d} -> {len(out):7d}")
    print(f"{args.iterations} iterations clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())
