"""Kernels K2 (RLE2 expansion) and K3 (word assembly), batched over blocks.

Counterparts of ``banzai_tpu/ops/stream_pallas.py`` (``rle2_expand_batch``
and ``pack_words_batch``).  Each wrapper launches its CUDA kernel
(``csrc/rle2_expand.cu``, ``csrc/pack_words.cu``) for CUDA tensors and
runs its plain PyTorch version for CPU tensors.
"""

from __future__ import annotations

import torch

from .._build import launch


def _check_same(name: str, tensors, shape, dtype, device) -> None:
    for t in tensors:
        if t.shape != shape or t.dtype != dtype or t.device != device:
            raise ValueError(
                f"{name}: expected {dtype} {tuple(shape)} on {device}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}"
            )


# ---------------------------------------------------------------------------
# K2: RLE2 expansion
# ---------------------------------------------------------------------------


def rle2_expand_plain(
    off: torch.Tensor, width: torch.Tensor, zp1: torch.Tensor,
    val: torch.Tensor, out_len: torch.Tensor,
) -> torch.Tensor:
    """Plain version: expand [B, M] RLE2 entries into [B, M] symbols.

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


def rle2_expand(
    off: torch.Tensor, width: torch.Tensor, zp1: torch.Tensor,
    val: torch.Tensor, out_len: torch.Tensor,
) -> torch.Tensor:
    """Expand int32 [B, M] entries (``rle2.rle2_entries``) into int32
    [B, M] symbols on the tensors' device: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    dev = off.device
    B, M = off.shape
    _check_same("rle2_expand", (off, width, zp1, val), (B, M),
                torch.int32, dev)
    _check_same("rle2_expand", (out_len,), (B,), torch.int32, dev)
    if dev.type == "cpu":
        return rle2_expand_plain(off, width, zp1, val, out_len)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    ts = (off, width, zp1, val, out_len)
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("rle2_expand: inputs must be contiguous")
    out = torch.empty((B, M), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        launch("rle2_expand", off, width, zp1, val, out_len, out, B, M)
    return out


# ---------------------------------------------------------------------------
# K3: word assembly
# ---------------------------------------------------------------------------


def pack_words_plain(
    w: torch.Tensor, hi2: torch.Tensor, total: torch.Tensor, nwords: int
) -> torch.Tensor:
    """Plain version: OR each entry's 32-bit ``hi2`` (int32 bit pattern)
    into word ``w``; entries with w >= nwords are dropped and words at or
    past ceil(total / 32) are 0.  Returns int32 [B, nwords] bit patterns.

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


def pack_words(
    w: torch.Tensor, hi2: torch.Tensor, total: torch.Tensor, nwords: int
) -> torch.Tensor:
    """Assemble int32 [B, E] (word, contribution) entries into int32
    [B, nwords] word bit patterns on the tensors' device: the CUDA kernel
    for CUDA tensors, the plain version for CPU tensors.  ``total`` is the
    int32 [B] bit count of each block."""
    dev = w.device
    B, E = w.shape
    _check_same("pack_words", (w, hi2), (B, E), torch.int32, dev)
    _check_same("pack_words", (total,), (B,), torch.int32, dev)
    if dev.type == "cpu":
        return pack_words_plain(w, hi2, total, nwords)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not (w.is_contiguous() and hi2.is_contiguous()):
        raise ValueError("pack_words: inputs must be contiguous")
    used = ((total + 31) >> 5).contiguous()
    words = torch.zeros((B, nwords), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        launch("pack_words", w, hi2, used, words, B, E, nwords)
    return words
