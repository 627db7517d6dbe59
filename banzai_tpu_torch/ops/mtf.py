"""Chunk-parallel MTF, batched over blocks.

Counterpart of ``banzai_tpu/ops/mtf.py`` (``mtf_indices_device``).  The
recency list at a chunk boundary is a closed-form function of each
symbol's last occurrence before the chunk, so every chunk's initial state
comes from a scatter-max, an exclusive cummax across chunks and one sort
of a packed key.  The sequential shuffle then runs only within chunks:
kernel K1 (``mtf_kernel.mtf_shuffle``).

The output does not depend on the chunk length.  The JAX pipeline runs
64, a choice for the TPU's sequential grid; on the card one warp runs one
chunk, and longer chunks shrink the chunk-state work (a scatter, a cummax
and a sort over [B, N / chunk, 256]) by the same factor.  ``CHUNK`` is
the length picked on an H100 (PERF.md).
"""

from __future__ import annotations

import torch

from .mtf_kernel import mtf_shuffle

_S = 256  # full byte alphabet; absent bytes sit inert at the tail

# The chunk with the least time for the whole ``mtf_indices`` (chunk
# states + K1) at level 9 on an H100, at both dispatch shapes (batches of
# 2 and 8 blocks), among 64..2048: ``tools/torch_mtf_chunks.py sweep``
# (PERF.md).
CHUNK = 2048
# On the CPU the plain shuffle takes one Python step per symbol of a
# chunk, so CPU runs keep the JAX pipeline's 64; the output is the same.
CPU_CHUNK = 64


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
    # int32 positions and keys where the key fits, (N + 1) << 9 < 2^31 (a
    # block of any level does): half the bytes of int64 through the
    # scatter, the cummax and the sort.
    idt = torch.int32 if (N + 1) << 9 < 1 << 31 else torch.int64
    pos = torch.arange(N, device=dev, dtype=idt).expand(B, N)
    # Last occurrence of each symbol in each chunk (global position); pad
    # lanes land in a spill column 256 that is dropped.
    col = torch.where(syms >= 0, syms.to(torch.int64), _S)
    slot = (torch.arange(C, device=dev) * (_S + 1)).repeat_interleave(chunk)
    occ = torch.full((B, C * (_S + 1)), -1, dtype=idt, device=dev)
    occ.scatter_reduce_(1, slot[None, :] + col, pos, reduce="amax")
    occ = occ.reshape(B, C, _S + 1)[:, :, :_S]
    # Exclusive cummax across chunks -> last occurrence before the chunk.
    before = torch.cat(
        [torch.full((B, 1, _S), -1, dtype=idt, device=dev),
         torch.cummax(occ, dim=1).values[:, :-1]], dim=1
    )
    sym_ids = torch.arange(_S, device=dev, dtype=idt)
    absent = (~present).to(idt)[:, None, :]
    key = ((N - before) << 9) | (absent << 8) | sym_ids
    key_s = torch.sort(key, dim=2).values
    return (key_s & 0xFF).to(torch.int32)


def mtf_indices(
    bwt: torch.Tensor, n: torch.Tensor, present: torch.Tensor,
    chunk: int | None = None,
) -> torch.Tensor:
    """MTF list positions of the BWT columns.

    bwt uint8 [B, N], n [B] true lengths, present bool [B, 256].  Returns
    int32 [B, N]; lanes at or past n hold -1.  ``chunk`` is the shuffle's
    chunk length (default ``CHUNK`` on a CUDA device, ``CPU_CHUNK`` on
    the CPU); the symbols are padded with -1 to a multiple of it here, and
    the result is the same for every chunk.
    """
    B, N = bwt.shape
    if chunk is None:
        chunk = CHUNK if bwt.device.type == "cuda" else CPU_CHUNK
    out = mtf_shuffle(*shuffle_inputs(bwt, n, present, chunk)).reshape(B, -1)
    return out if out.shape[1] == N else out[:, :N].contiguous()


def shuffle_inputs(
    bwt: torch.Tensor, n: torch.Tensor, present: torch.Tensor, chunk: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """K1's inputs for ``mtf_indices`` at ``chunk``: the symbols, int32
    [B * C, chunk] with -1 at and past each row's n, and the chunk states,
    int32 [B * C, 256], where C = ceil(N / chunk)."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    B, N = bwt.shape
    dev = bwt.device
    C = -(-N // chunk)
    pos = torch.arange(C * chunk, device=dev)[None, :]
    syms = torch.full((B, C * chunk), -1, dtype=torch.int32, device=dev)
    syms[:, :N] = bwt
    syms = torch.where(pos < n.to(dev)[:, None], syms, -1)
    state0 = chunk_states(syms, present, chunk)
    return syms.reshape(B * C, chunk), state0.reshape(B * C, _S)
