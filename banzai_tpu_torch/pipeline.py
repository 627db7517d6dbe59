"""Orchestration: host RLE1 blocks -> device batches -> .bz2 stream.

Counterpart of ``banzai_tpu/pipeline.py`` (``compress_blocks_payloads``
and ``compress``), reduced to one device and synchronous batches.  Per
batch: the host packs the blocks into one uint8 row array, the device
runs ``block.encode_batch_rows``, and the host copies back the bit
counts, the plan totals, banzai's table split and the first
ceil(max nbits / 32) words of every row, checks each block, and splices
its payload into the container.

A device failure raises.  Blocks go to the host encoder only by rule:
tiny blocks, a payload past the word capacity, or a block where banzai's
exact plan is strictly smaller (the <=-banzai contract).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from banzai_tpu.bitio import BitWriter
from banzai_tpu.constants import MAX_SYMS as S, SEGMENT_WIDTH, block_capacity
from banzai_tpu.container import write_stream_footer, write_stream_header
from banzai_tpu.crc32 import combine_stream_crc
from banzai_tpu.encoder_host import TINY_BLOCK, block_plan
from banzai_tpu.huffman_host import banzai_wins, write_entropy
from banzai_tpu.rle1 import iter_blocks

from ._device import resolve_device
from .block import ROW_EXTRA, encode_batch_rows, stage
from .payload import BlockPayload

_CHUNK = 64           # MTF chunk length
_DEFAULT_BATCH = 8    # blocks per device batch at level >= 5


@dataclass
class EncodeStats:
    """What a ``compress`` call did, for callers that want to know.

    ``device_blocks`` counts blocks encoded on the device path; the
    ``host_*`` fields count blocks that went to the host encoder, by
    rule.  When ``stage_ms`` is a dict, every stage synchronises the
    device and adds its wall time (ms) there; when it is None (the
    default) nothing waits."""
    device_blocks: int = 0
    host_tiny: int = 0
    host_capacity: int = 0
    host_banzai: int = 0
    batches: int = 0
    stage_ms: dict | None = None


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


def stage_rows(outputs: list[np.ndarray], N: int, batch: int):
    """Pack RLE1 block outputs into one uint8 [tgt, N + 260] row array.

    tgt is the next power of two >= len(outputs), at most ``batch``;
    dummy rows hold one byte 0.  Returns (rows, present bool [tgt, 256])."""
    tgt = min(batch, 1 << (len(outputs) - 1).bit_length())
    arr = np.zeros((tgt, N + ROW_EXTRA), np.uint8)
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
    return arr, pres


def _encode_group(group, *, N, nseg, nwords, batch, device, stats):
    """Encode one batch of RLE1 blocks on the device; one payload each."""
    sm = stats.stage_ms
    with stage(sm, "stage_rows", device):
        arr, pres = stage_rows([blk.output for blk in group], N, batch)
    with stage(sm, "upload", device):
        rows = torch.from_numpy(arr).to(device)
    words_d, nbits_d, ptrs_d, planb_d, splits_d, mlens_d = encode_batch_rows(
        rows, nseg=nseg, nwords=nwords, chunk=_CHUNK, stage_ms=sm,
    )
    with stage(sm, "fetch", device):
        B = len(group)
        head = torch.stack([nbits_d, ptrs_d, planb_d, mlens_d.to(torch.int64)])
        nbits, ptrs, plan_bits, mlens = head[:, :B].cpu().numpy()
        splits = splits_d[:B].cpu().numpy()
        k = max(1, (int(nbits.max()) + 31) // 32)
        words = (
            words_d[:B, : min(k, nwords)].contiguous().cpu().numpy()
            .view(np.uint32)
        )
    stats.batches += 1
    out = []
    with stage(sm, "drain", device):
        for i, blk in enumerate(group):
            if int(nbits[i]) > nwords * 32:
                # Past the word capacity (see _nwords): the device words
                # are truncated, so encode this block on the host.
                stats.host_capacity += 1
                out.append(_host_payload(blk))
            elif banzai_wins(splits[i], int(pres[i].sum()) + 2,
                             int(mlens[i]), int(plan_bits[i])):
                # The <=-banzai contract: banzai's exact plan is strictly
                # smaller; the host encoder's candidates include it.
                stats.host_banzai += 1
                out.append(_host_payload(blk))
            else:
                stats.device_blocks += 1
                out.append(BlockPayload(
                    crc=blk.crc, ptr=int(ptrs[i]), present=pres[i],
                    words=words[i], nbits=int(nbits[i]),
                ))
    return out


def compress_blocks_payloads(
    data: bytes,
    level: int = 9,
    device: str | torch.device = "cuda",
    stats: EncodeStats | None = None,
) -> list[BlockPayload]:
    """Encode ``data`` into per-block payloads, in input order."""
    dev = resolve_device(device)
    stats = stats if stats is not None else EncodeStats()
    N = _padded_len(level)
    nseg = (N + 1 + SEGMENT_WIDTH - 1) // SEGMENT_WIDTH
    nwords = _nwords(N, nseg)
    batch = _batch_for_level(level)

    payloads: list[BlockPayload | None] = []
    group: list = []
    slots: list[int] = []

    def flush() -> None:
        for i, p in zip(slots, _encode_group(
            group, N=N, nseg=nseg, nwords=nwords, batch=batch, device=dev,
            stats=stats,
        )):
            payloads[i] = p
        group.clear()
        slots.clear()

    blocks = iter_blocks(data, level)
    while True:
        with stage(stats.stage_ms, "rle1", dev):
            blk = next(blocks, None)
        if blk is None:
            break
        if len(blk.output) <= TINY_BLOCK:
            # Only a stream's final block can be this small; padding it to
            # the full device shape would waste a batch slot.
            stats.host_tiny += 1
            payloads.append(_host_payload(blk))
            continue
        slots.append(len(payloads))
        payloads.append(None)
        group.append(blk)
        if len(group) == batch:
            flush()
    if group:
        flush()
    return payloads


def compress(
    data: bytes,
    level: int = 9,
    device: str | torch.device = "cuda",
    stats: EncodeStats | None = None,
) -> bytes:
    """Encode ``data`` into a .bz2 stream on ``device``."""
    bw = BitWriter()
    write_stream_header(bw, level)
    stream_crc = 0
    for p in compress_blocks_payloads(data, level, device, stats):
        stream_crc = combine_stream_crc(stream_crc, p.crc)
        p.write(bw)
    write_stream_footer(bw, stream_crc)
    return bw.close()
