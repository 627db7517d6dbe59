"""Chunk-parallel MTF, batched over blocks.

Counterpart of ``banzai_tpu/ops/mtf.py`` (``mtf_indices_device``).  The
recency list at a chunk boundary is a closed-form function of each
symbol's last occurrence before the chunk, so every chunk's initial state
comes from a scatter-max, an exclusive cummax across chunks and one sort
of a packed key.  The sequential shuffle then runs only within chunks:
kernel K1 (``mtf_kernel.mtf_shuffle``).
"""

from __future__ import annotations

import torch

from .mtf_kernel import mtf_shuffle

_S = 256  # full byte alphabet; absent bytes sit inert at the tail


def chunk_states(
    syms: torch.Tensor, present: torch.Tensor, chunk: int
) -> torch.Tensor:
    """Initial recency state of every chunk: int32 [B, C, 256].

    syms int32 [B, N] (pad -1), present bool [B, 256].  A chunk's state
    lists the symbols by last occurrence before the chunk, latest first,
    then the never-seen present bytes ascending, then the absent bytes.
    """
    B, N = syms.shape
    C = N // chunk
    dev = syms.device
    pos = torch.arange(N, device=dev, dtype=torch.int64).expand(B, N)
    # Last occurrence of each symbol in each chunk (global position); pad
    # lanes land in a spill column 256 that is dropped.
    col = torch.where(syms >= 0, syms.to(torch.int64), _S)
    slot = (torch.arange(C, device=dev) * (_S + 1)).repeat_interleave(chunk)
    occ = torch.full((B, C * (_S + 1)), -1, dtype=torch.int64, device=dev)
    occ.scatter_reduce_(1, slot[None, :] + col, pos, reduce="amax")
    occ = occ.reshape(B, C, _S + 1)[:, :, :_S]
    # Exclusive cummax across chunks -> last occurrence before the chunk.
    before = torch.cat(
        [torch.full((B, 1, _S), -1, dtype=torch.int64, device=dev),
         torch.cummax(occ, dim=1).values[:, :-1]], dim=1
    )
    sym_ids = torch.arange(_S, device=dev, dtype=torch.int64)
    absent = (~present).to(torch.int64)[:, None, :]
    key = ((N - before) << 9) | (absent << 8) | sym_ids
    key_s = torch.sort(key, dim=2).values
    return (key_s & 0xFF).to(torch.int32)


def mtf_indices(
    bwt: torch.Tensor, n: torch.Tensor, present: torch.Tensor,
    chunk: int = 64,
) -> torch.Tensor:
    """MTF list positions of the BWT columns.

    bwt uint8 [B, N] (N a multiple of ``chunk``), n [B] true lengths,
    present bool [B, 256].  Returns int32 [B, N]; lanes at or past n hold
    -1.  The pipeline runs chunk = 64.
    """
    B, N = bwt.shape
    if N % chunk:
        raise ValueError(f"N = {N} is not a multiple of chunk = {chunk}")
    dev = bwt.device
    pos = torch.arange(N, device=dev)[None, :]
    syms = torch.where(pos < n.to(dev)[:, None], bwt.to(torch.int32), -1)
    state0 = chunk_states(syms, present, chunk)
    C = N // chunk
    out = mtf_shuffle(
        syms.reshape(B * C, chunk), state0.reshape(B * C, _S)
    )
    return out.reshape(B, N)
