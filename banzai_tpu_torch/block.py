"""The per-batch device body: packed rows in, packed payload words out.

Counterpart of ``banzai_tpu/parallel/dp.py`` (``encode_batch_rows``, its
``use_pallas`` branch).  The batch dimension is written out where the JAX
version was vmapped; the three kernels (MTF shuffle, RLE2 expansion, word
assembly) run batch-wide.
"""

from __future__ import annotations

import time
from contextlib import contextmanager, nullcontext

import torch

from .ops.bitpack import block_payload_entries, splice_entries
from .ops.bwt import bwt_rotations
from .ops.huffman import plan_entropy
from .ops.mtf import mtf_indices
from .ops.rle2 import rle2_entries
from .ops.stream_kernels import as_int32_bits, pack_words, rle2_expand

# Packed-row layout of one batch upload: N block bytes, 256 presence
# bytes, 3 little-endian length bytes, 1 spare.
ROW_EXTRA = 260


def nvtx_range(name: str, device: torch.device):
    """An NVTX range named ``name`` on a CUDA device (what a profiler's
    timeline shows for the enclosed host step); nothing on the CPU."""
    return torch.cuda.nvtx.range(name) if device.type == "cuda" else nullcontext()


@contextmanager
def stage(stage_ms: dict | None, name: str, device: torch.device):
    """Open an NVTX range for the enclosed stage, and add its wall time to
    ``stage_ms[name]`` (ms), synchronising the device before and after.
    With ``stage_ms`` None nothing is timed and nothing waits."""
    with nvtx_range(name, device):
        if stage_ms is None:
            yield
            return
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        stage_ms[name] = (
            stage_ms.get(name, 0.0) + 1e3 * (time.perf_counter() - t0)
        )


def unpack_rows(rows: torch.Tensor):
    """(blocks uint8 [B, N], n int64 [B], present bool [B, 256])."""
    N = rows.shape[1] - ROW_EXTRA
    blocks = rows[:, :N]
    present = rows[:, N : N + 256] != 0
    nb = rows[:, N + 256 : N + 259].to(torch.int64)
    ns = nb[:, 0] | (nb[:, 1] << 8) | (nb[:, 2] << 16)
    return blocks, ns, present


def encode_batch_rows(
    rows: torch.Tensor, *, nseg: int, nwords: int, chunk: int,
    stage_ms: dict | None = None,
):
    """Encode every block of a packed uint8 [B, N + 260] row batch.

    Returns (words int32 [B, nwords] uint32 bit patterns, nbits [B],
    ptr [B], plan_bits [B], banzai split [B, 3, 258], out_len [B]), the
    tuple of ``banzai_tpu.parallel.dp.encode_batch_rows``.
    """
    dev = rows.device
    blocks, ns, present = unpack_rows(rows)
    num_names = present.sum(dim=1)
    with stage(stage_ms, "bwt", dev):
        bwt, ptrs = bwt_rotations(blocks, ns)
    with stage(stage_ms, "mtf", dev):
        idx = mtf_indices(bwt, ns, present, chunk)
    with stage(stage_ms, "rle2", dev):
        off, width, zp1, val, out_len = rle2_entries(idx, ns, num_names)
        syms = rle2_expand(off, width, zp1, val, out_len)
    with stage(stage_ms, "plan", dev):
        plan = plan_entropy(syms, out_len, num_names + 2, nseg)
    with stage(stage_ms, "entries", dev):
        vals, lens = block_payload_entries(
            syms, out_len, num_names + 2, plan["num_tables"], plan["tables"],
            plan["selectors"], plan["sel_mtf_idx"], plan["nseg_used"],
        )
        w, hi2, total = splice_entries(vals, lens)
    with stage(stage_ms, "pack", dev):
        words = pack_words(
            torch.clamp(w, max=nwords).to(torch.int32), as_int32_bits(hi2),
            total.to(torch.int32), nwords,
        )
    return (words, total, ptrs, plan["total_bits"], plan["banzai_split"],
            out_len)
