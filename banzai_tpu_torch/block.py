"""The per-batch device body: packed rows in, packed payload words out.

Counterpart of ``banzai_tpu/parallel/dp.py`` (``encode_batch_rows``, its
``use_pallas`` branch).  The batch dimension is written out where the JAX
version was vmapped; the three kernels (MTF shuffle, MTF indices to RLE2
symbols, payload entries to words) run batch-wide.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager

import torch

from .ops.bitpack import block_payload_entries
from .ops.bwt import bwt_rotations
from .ops.huffman import plan_entropy
from .ops.mtf import mtf_indices
from .ops.stream_kernels import pack_words_batch, rle2_expand_batch
from .spans import mark, span

# Packed-row layout of one batch upload: N block bytes, 256 presence
# bytes, 3 little-endian length bytes, 1 spare.
ROW_EXTRA = 260


_STAGE_MS_LOCK = threading.Lock()   # device threads share one stage_ms
# The stages whose interval on the card EncodeStats.device_ms keeps.
_TIMED = frozenset({"bwt", "plan"})


@contextmanager
def stage(stage_ms: dict | None, name: str, device: torch.device):
    """One device stage: a span named ``name`` (``spans.span``) and, for
    a stage in ``_TIMED``, a mark on the current stream at its start and
    one named ``name`` at its end (``spans.mark``).  When ``stage_ms`` is
    a dict, also add the stage's wall time (ms) to ``stage_ms[name]``,
    synchronising the device before and after, with the start mark after
    the first synchronisation, so that its interval on the card's clock
    is the one the host clock times; with ``stage_ms`` None nothing
    waits."""
    timed = name in _TIMED
    wait = stage_ms is not None and device.type == "cuda"
    with span(name):
        if wait:
            torch.cuda.synchronize(device)
        if timed:
            mark(None)
        t0 = time.perf_counter()
        yield
        if timed:
            mark(name)
        if stage_ms is None:
            return
        if wait:
            torch.cuda.synchronize(device)
        dt = 1e3 * (time.perf_counter() - t0)
        with _STAGE_MS_LOCK:
            stage_ms[name] = stage_ms.get(name, 0.0) + dt


def unpack_rows(rows: torch.Tensor):
    """(blocks uint8 [B, N], n int64 [B], present bool [B, 256])."""
    N = rows.shape[1] - ROW_EXTRA
    blocks = rows[:, :N]
    present = rows[:, N : N + 256] != 0
    nb = rows[:, N + 256 : N + 259].to(torch.int64)
    ns = nb[:, 0] | (nb[:, 1] << 8) | (nb[:, 2] << 16)
    return blocks, ns, present


def encode_batch_rows(
    rows: torch.Tensor, *, nseg: int, nwords: int, chunk: int | None = None,
    stage_ms: dict | None = None,
):
    """Encode every block of a packed uint8 [B, N + 260] row batch.

    ``chunk`` is the MTF chunk length (default: ``ops.mtf.mtf_indices``'s
    for the device); the output does not depend on it.

    Returns (words int32 [B, nwords] uint32 bit patterns, nbits [B],
    ptr [B], plan_bits [B], banzai split [B, 3, 258], out_len [B]), the
    tuple of ``banzai_tpu.parallel.dp.encode_batch_rows``.
    """
    dev = rows.device
    blocks, ns, present = unpack_rows(rows)
    num_names = present.sum(dim=1)
    num_syms = num_names + 2
    with stage(stage_ms, "bwt", dev):
        bwt, ptrs = bwt_rotations(blocks, ns)
    with stage(stage_ms, "mtf", dev):
        idx = mtf_indices(bwt, ns, present, chunk)
    with stage(stage_ms, "rle2", dev):
        syms, out_len = rle2_expand_batch(idx, ns, num_names)
    with stage(stage_ms, "plan", dev):
        plan = plan_entropy(syms, out_len, num_syms, nseg)
    with stage(stage_ms, "entries", dev):
        vals, lens = block_payload_entries(
            syms, out_len, num_syms, plan["num_tables"], plan["tables"],
            plan["selectors"], plan["sel_mtf_idx"], plan["nseg_used"],
        )
    with stage(stage_ms, "pack", dev):
        words, total = pack_words_batch(vals, lens, nwords)
    return (words, total, ptrs, plan["total_bits"], plan["banzai_split"],
            out_len)
