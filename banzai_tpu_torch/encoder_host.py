"""Host (NumPy) production encoder: the full per-block pipeline on the host.

Copy of ``banzai_tpu/encoder_host.py``, so the port imports nothing of the
JAX package; only the imports differ, and the output is byte for byte the
original's.

This backend is the differential twin of the device pipeline — identical
algorithms (cyclic rotation sort, chunk-parallel MTF, package-merge entropy
plan), NumPy execution.  It is also the fallback when no accelerator is
present.  Output is guaranteed valid .bz2 and — via the adaptive entropy
candidate search — no larger than the banzai model's on every tested input.
"""

from __future__ import annotations

import numpy as np

from .bitio import BitWriter
from .container import (
    write_block_header,
    write_stream_footer,
    write_stream_header,
    write_sym_map,
)
from .crc32 import combine_stream_crc
from .huffman_host import plan_entropy, write_entropy
from .mtf_rle2 import mtf_indices, rle2_encode
from .oracle.stages import numpy_bwt
from .rle1 import iter_blocks

# Blocks at or below this many RLE1 bytes are routed to the host by the
# device pipeline — only a stream's FINAL block can be this small
# (interior blocks always fill to the level's capacity), and padding one
# tiny tail block to the full device shape wastes a batch slot.  Output
# is byte-identical either way: since round 4 every backend includes the
# quirk-exact banzai plan as an entropy candidate on every block
# (plan_entropy / ops.banzai_plan), so this constant is purely a routing
# heuristic, not a size-contract guard.
TINY_BLOCK = 16384


def compress(data: bytes, level: int = 9, jobs: int | None = None) -> bytes:
    """Encode ``data`` to a .bz2 stream (host backend).

    ``jobs``: worker processes for block-parallel encode (blocks are
    independent; output is byte-identical at any job count since the
    ordered stitch is the only shared state — the host analog of the
    device pipeline's block-DP axis).  Default: BANZAI_HOST_JOBS, else
    all cores when ``__main__`` is a real importable file, else 1.
    Workers are SPAWNED, never forked — the parent may hold CUDA runtime
    threads, and forking a multithreaded process deadlocks (utils.pool);
    the workers import neither torch nor the CUDA runtime.  Spawn
    re-imports ``__main__`` in each worker, which explodes for
    stdin/interactive parents (there is no file to re-run), hence the
    importable-main check before auto-pooling;
    explicit ``jobs=``/env requests are honored as given.
    """
    import os

    if jobs is None:
        jobs = int(os.environ.get("BANZAI_HOST_JOBS", "0"))
        if not jobs:
            import __main__

            mf = getattr(__main__, "__file__", None)
            spawn_safe = bool(mf) and os.path.isfile(mf)
            jobs = (os.cpu_count() or 1) if spawn_safe else 1

    bw = BitWriter()
    write_stream_header(bw, level)
    stream_crc = 0
    blocks = iter_blocks(data, level)
    if jobs > 1:
        import itertools

        from .utils.pool import spawn_pool

        head = list(itertools.islice(blocks, 3))
        if len(head) >= 3:                    # enough work for a pool
            with spawn_pool(jobs) as pool:
                crcs = []

                def _outputs():
                    for blk in itertools.chain(head, blocks):
                        crcs.append(blk.crc)
                        yield np.ascontiguousarray(blk.output)

                for i, (ptr, present, raw, nbits) in enumerate(
                    pool.imap(_pool_block, _outputs())
                ):
                    crc = crcs[i]
                    stream_crc = combine_stream_crc(stream_crc, crc)
                    write_block_header(bw, crc, ptr)
                    write_sym_map(bw, present)
                    raw = raw + b"\x00" * (-len(raw) % 4)
                    words = np.frombuffer(raw, dtype=">u4")
                    bw.splice_words(words, nbits)
            write_stream_footer(bw, stream_crc)
            return bw.close()
        blocks = iter(head)
    for blk in blocks:
        stream_crc = combine_stream_crc(stream_crc, blk.crc)
        encode_block(bw, blk.output, blk.crc)
    write_stream_footer(bw, stream_crc)
    return bw.close()


def _pool_block(output):
    """Worker: one block -> (ptr, present, entropy payload bytes, nbits).
    Touches only NumPy + the native kernels; this module's import chain
    is torch-free, so spawn workers resolving it by path stay CPU-only."""
    ptr, present, syms, plan = block_plan(output)
    pbw = BitWriter()
    write_entropy(pbw, syms, plan)
    return ptr, present, pbw.close(), pbw.bit_length


def hybrid_block(output):
    """Spawn-pool worker for the hybrid host+device scheduler
    (pipeline.compress_blocks_payloads): one RLE1 block -> payload words.
    Lives here — not in pipeline.py — so spawn workers unpickling it by
    import path never import torch."""
    ptr, present, raw, nbits = _pool_block(output)
    raw = raw + b"\x00" * (-len(raw) % 4)
    words = np.frombuffer(raw, dtype=">u4").astype(np.uint32)
    return ptr, present, words, nbits


def block_plan(rle1_out: np.ndarray):
    """The five-stage host pipeline for one block: (ptr, present, syms,
    plan).  The ONE implementation shared by the host backend and the
    device-failure fallback (pipeline._host_payload) — they must emit
    byte-identical streams, so the stages live in exactly one place.

    BWT prefers the native SA-IS (linear time, ~20x the NumPy rotation
    sort; differentially tested byte-exact incl. ptr); numpy_bwt is the
    portable fallback and the independent test oracle."""
    from .native import host_bwt_native, mtf_native

    got = host_bwt_native(rle1_out)
    if got is not None:
        bwt, ptr = got
    else:
        bwt, ptr = numpy_bwt(rle1_out)
    present = np.zeros(256, dtype=bool)
    present[rle1_out] = True
    num_names = int(present.sum())
    idx = mtf_native(bwt, present)
    if idx is None:
        idx = mtf_indices(bwt, present)
    syms, freqs = rle2_encode(idx, num_names)
    plan = plan_entropy(syms, num_names + 2, freqs)
    return ptr, present, syms, plan


def encode_block(bw: BitWriter, rle1_out: np.ndarray, crc: int) -> tuple[int, int]:
    """Write one block; returns (ptr, entropy_payload_bits) so callers can
    report the same numbers the device path does (BlockStats contract:
    payload bits exclude the header/symbol map)."""
    ptr, present, syms, plan = block_plan(rle1_out)
    write_block_header(bw, crc, ptr)
    write_sym_map(bw, present)
    bits0 = bw.bit_length
    write_entropy(bw, syms, plan)
    return ptr, bw.bit_length - bits0
