"""Kernel K4: stream compaction (``csrc/compact_stream.cu``).

Counterpart of ``banzai_tpu/ops/compact_pallas.py`` (``compact_stream``),
a standalone op: no stage of the encoder calls it, as none of the JAX
package does.  ``compact_stream`` launches the CUDA kernel for CUDA
tensors and runs the plain PyTorch version, ``compact_stream_plain``, for
CPU tensors.  Both write 0 to the lanes past the count, where the JAX
version leaves garbage, so the two can be compared over all lanes.
"""

from __future__ import annotations

import torch

from .._build import launch


def _check(mask: torch.Tensor, payload: torch.Tensor, tile: int) -> None:
    if mask.dim() != 1 or payload.shape != mask.shape:
        raise ValueError(
            f"mask and payload must be 1-D of one length, got "
            f"{tuple(mask.shape)} and {tuple(payload.shape)}"
        )
    if mask.device != payload.device:
        raise ValueError("mask and payload lie on different devices")
    if tile <= 0 or mask.shape[0] % tile:
        raise ValueError(
            f"length {mask.shape[0]} is not a multiple of tile {tile}"
        )


def compact_stream_plain(
    mask: torch.Tensor, payload: torch.Tensor, tile: int = 512
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version: (packed int32 [N], count int64 []) with
    ``packed[:count] = payload[mask != 0]`` and 0 past the count."""
    _check(mask, payload, tile)
    keep = mask != 0
    N = keep.shape[0]
    # Kept lanes scatter to their rank; the others to a spill slot past N.
    dest = torch.where(keep, torch.cumsum(keep, 0) - 1, N)
    out = torch.zeros(N + 1, dtype=torch.int32, device=mask.device)
    out.scatter_(0, dest, payload.to(torch.int32))
    return out[:N], keep.sum()


def compact_stream(
    mask: torch.Tensor, payload: torch.Tensor, tile: int = 512
) -> tuple[torch.Tensor, torch.Tensor]:
    """Pack ``payload[mask != 0]`` to the front of an int32 [N] buffer.

    Returns (packed, count int64 []); lanes at or past ``count`` are 0.
    ``N`` must be a multiple of ``tile`` (a multiple of 32 up to 1024 on
    the card: one CTA per tile).  On the card one launch runs the tile
    counts, their scan and the placement (``csrc/compact_stream.cu``) on
    the bool mask.  Nothing waits for the device."""
    _check(mask, payload, tile)
    dev = mask.device
    if dev.type == "cpu":
        return compact_stream_plain(mask, payload, tile)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if tile % 32 or not 32 <= tile <= 1024:
        raise ValueError(f"tile {tile} is not a multiple of 32 in [32, 1024]")
    m = (mask if mask.dtype == torch.bool else mask != 0).contiguous()
    if m.data_ptr() % 4:
        m = m.clone()             # the kernel reads the mask as words
    pay = payload.to(torch.int32).contiguous()
    n = m.shape[0]
    n_tiles = n // tile
    out = torch.empty(n, dtype=torch.int32, device=dev)
    if not n_tiles:
        return out, torch.zeros((), dtype=torch.int64, device=dev)
    counts = torch.empty(n_tiles, dtype=torch.int32, device=dev)
    # offs[t]: kept lanes before tile t; offs[n_tiles]: the count.
    offs = torch.empty(n_tiles + 1, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        launch("compact_stream", m, pay, counts, offs, out, n_tiles, tile)
    return out, offs[n_tiles]
