"""Kernels K2 (MTF indices to RLE2 symbols) and K3 (payload entries to
words), batched over blocks.

Counterparts of ``banzai_tpu/ops/stream_pallas.py``'s
``rle2_expand_batch`` and ``pack_words_batch``, each the whole function:
the entry passes that the JAX functions run around their Pallas kernels
(``rle2_entries``, ``splice_entries``) are inside the CUDA entry points
(``csrc/rle2_expand.cu``, ``csrc/pack_words.cu``).  Each wrapper launches
its kernels for CUDA tensors and runs its plain PyTorch version for CPU
tensors; ``rle2.rle2_entries`` and ``bitpack.splice_entries`` remain as
the plain versions' first halves.
"""

from __future__ import annotations

import torch

from .._build import launch
from .rle2 import rle2_entries

# Lanes (K2) and entries (K3) per tile of the kernels' grids; the entry
# points check the tile counts computed from them.
RLE2_TILE = 2048
PACK_TILE = 2048


def _check_same(name: str, tensors, shape, dtype, device) -> None:
    for t in tensors:
        if t.shape != shape or t.dtype != dtype or t.device != device:
            raise ValueError(
                f"{name}: expected {dtype} {tuple(shape)} on {device}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}"
            )


def _cuda_or_raise(name: str, device: torch.device, tensors) -> None:
    if device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: inputs must be contiguous")


# ---------------------------------------------------------------------------
# K2: MTF indices -> RLE2 symbols
# ---------------------------------------------------------------------------


def rle2_expand_plain(
    off: torch.Tensor, width: torch.Tensor, zp1: torch.Tensor,
    val: torch.Tensor, out_len: torch.Tensor,
) -> torch.Tensor:
    """Expand [B, M] RLE2 entries (``rle2.rle2_entries``) into [B, M]
    symbols.

    Entry (off, width, zp1, val) fills slots [off, off + width): the
    width - 1 bits of zp1 below its leading one, LSB first, then val.
    Slots at or past ``out_len`` are 258.
    """
    B, M = off.shape
    dev = off.device
    w = width.reshape(-1).to(torch.int64)
    ent = torch.repeat_interleave(torch.arange(B * M, device=dev), w)
    starts = torch.cumsum(w, 0) - w
    d = torch.arange(ent.numel(), device=dev) - starts[ent]
    z = zp1.reshape(-1)[ent].to(torch.int64)
    v = torch.where(
        d == w[ent] - 1, val.reshape(-1)[ent].to(torch.int64), (z >> d) & 1
    )
    flat = (ent // M) * M + off.reshape(-1)[ent].to(torch.int64) + d
    out = torch.full((B * M,), 258, dtype=torch.int32, device=dev)
    out[flat] = v.to(torch.int32)
    return out.reshape(B, M)


def rle2_expand_batch_plain(
    mtf_idx: torch.Tensor, n: torch.Tensor, num_names: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``rle2_expand_batch``: the entry stream, then its
    expansion."""
    ent = rle2_entries(mtf_idx, n, num_names)
    return rle2_expand_plain(*ent), ent[4]


def rle2_expand_batch(
    mtf_idx: torch.Tensor, n: torch.Tensor, num_names: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """RLE2 of int32 [B, N] MTF indices with true lengths ``n`` [B] and
    ``num_names`` [B] distinct bytes: (symbols int32 [B, N + 1], 258 from
    out_len on; out_len int32 [B]).  Lanes at or past n are not read.

    One CUDA entry point for CUDA tensors, the plain version for CPU
    tensors."""
    dev = mtf_idx.device
    if mtf_idx.dim() != 2:
        raise ValueError("rle2_expand_batch: mtf_idx must be [B, N]")
    B, N = mtf_idx.shape
    _check_same("rle2_expand_batch", (mtf_idx,), (B, N), torch.int32, dev)
    for t in (n, num_names):
        if t.shape != (B,) or t.device != dev or t.is_floating_point():
            raise ValueError(
                f"rle2_expand_batch: n and num_names must be integer [{B}] "
                f"on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if dev.type == "cpu":
        return rle2_expand_batch_plain(mtf_idx, n, num_names)
    n64 = n.to(torch.int64)            # no copy when already int64
    names64 = num_names.to(torch.int64)
    _cuda_or_raise("rle2_expand_batch", dev, (mtf_idx, n64, names64))
    n_tiles = -(-(N + 1) // RLE2_TILE)
    syms = torch.empty((B, N + 1), dtype=torch.int32, device=dev)
    out_len = torch.empty(B, dtype=torch.int32, device=dev)
    scratch = torch.empty(5 * B * n_tiles, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        launch("rle2_expand", mtf_idx, n64, names64, syms, out_len, scratch,
               B, N, n_tiles)
    return syms, out_len


# ---------------------------------------------------------------------------
# K3: payload entries -> words
# ---------------------------------------------------------------------------


def pack_words_plain(
    w: torch.Tensor, hi2: torch.Tensor, total: torch.Tensor, nwords: int
) -> torch.Tensor:
    """OR each entry's 32-bit ``hi2`` (``bitpack.splice_entries``) into
    word ``w``; entries with w >= nwords are dropped and words at or past
    ceil(total / 32) are 0.  Returns int32 [B, nwords] bit patterns.

    The fields within a word are disjoint, so OR equals ADD and a
    scatter-add in int64 computes it exactly."""
    B, E = w.shape
    dev = w.device
    h = hi2.to(torch.int64) & 0xFFFFFFFF
    acc = torch.zeros((B, nwords + 1), dtype=torch.int64, device=dev)
    acc.scatter_add_(1, torch.clamp(w.to(torch.int64), max=nwords), h)
    words = acc[:, :nwords]
    used = (total.to(torch.int64) + 31) >> 5
    widx = torch.arange(nwords, device=dev)[None, :]
    words = torch.where(widx < used[:, None], words, 0)
    return as_int32_bits(words)


def as_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensors with the same bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def pack_words_batch_plain(
    vals: torch.Tensor, lens: torch.Tensor, nwords: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``pack_words_batch``: ``bitpack.pack_entries``
    (the entries' word fields, then their assembly), total as int32."""
    from .bitpack import pack_entries

    words, total = pack_entries(vals, lens, nwords)
    return words, total.to(torch.int32)


def pack_words_batch(
    vals: torch.Tensor, lens: torch.Tensor, nwords: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Pack int64 [B, E] (value, bit length) entries, as
    ``bitpack.block_payload_entries`` gives them (lengths in [0, 32]), MSB
    first: (words int32 [B, nwords], the uint32 bit patterns, 0 from
    ceil(total / 32) on, bits past word nwords dropped; total int32 [B],
    the full bit count even past nwords * 32).

    One CUDA entry point for CUDA tensors, the plain version for CPU
    tensors."""
    dev = vals.device
    if vals.dim() != 2:
        raise ValueError("pack_words_batch: vals must be [B, E]")
    B, E = vals.shape
    _check_same("pack_words_batch", (vals, lens), (B, E), torch.int64, dev)
    if dev.type == "cpu":
        return pack_words_batch_plain(vals, lens, nwords)
    _cuda_or_raise("pack_words_batch", dev, (vals, lens))
    n_tiles = max(1, -(-E // PACK_TILE))
    words = torch.empty((B, nwords), dtype=torch.int32, device=dev)
    total = torch.empty(B, dtype=torch.int32, device=dev)
    scratch = torch.empty(2 * B * n_tiles, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        launch("pack_words", vals, lens, words, total, scratch, B, E, nwords,
               n_tiles)
    return words, total
