"""Wrap-around BWT by cyclic prefix doubling, batched over blocks.

Counterpart of ``banzai_tpu/ops/bwt.py`` (``bwt_rotations``).  The output
is the same; the structure is plain Manber-Myers over the n rotations of
each block, with no TPU-shaped rounds (packed 15-byte prefix, chain
resolution, compact tiers):

* a round packs (block, rank[i], rank[(i + k) mod n]) into one int64 key
  and sorts every block of the batch with one ``torch.sort``;
* a rank is the index of the rotation's tie group in sorted order (a
  running count of group heads), and ``ptr``, the number of rotations
  strictly smaller than rotation 0, counts the rotations ranked below it;
* a round that splits no group is a fixpoint (the remaining ties are
  identical rotations, as on periodic input), and a round whose prefix
  covers the whole rotation is final.

Padded lanes carry a rank above every real one, so they sort after every
real rotation of their block.
"""

from __future__ import annotations

import torch

from ..spans import read_int, span
from ._scan import row_cumsum

_RANK_BITS = 21
_PAD = 1 << (_RANK_BITS - 1)   # rank of padded lanes; real ranks < n < 2^20


def bwt_rotations(
    block: torch.Tensor, n: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """BWT of ``block[b, :n[b]]`` for every row b.

    Args:
      block: uint8 [B, N] padded blocks.
      n: [B] true lengths, 1 <= n <= N < 2^20.
    Returns:
      (bwt uint8 [B, N], first n[b] entries valid; ptr int64 [B]).
    """
    B, N = block.shape
    if N >= _PAD:
        raise ValueError(f"block length {N} needs more than 20 rank bits")
    if B >= 1 << (63 - 2 * _RANK_BITS):
        raise ValueError(f"batch {B} too large for the packed sort key")
    dev = block.device
    n64 = n.to(device=dev, dtype=torch.int64)[:, None]
    idx = torch.arange(N, device=dev, dtype=torch.int64)[None, :]
    valid = idx < n64
    nsafe = torch.clamp(n64, min=1)
    rows = torch.arange(B, device=dev, dtype=torch.int64)[:, None]
    row_hi = rows << (2 * _RANK_BITS)
    row_base = rows * N

    rank = torch.where(valid, block.to(torch.int64), _PAD)
    # Groups before the first round: distinct byte values per block.
    seen = torch.zeros(B * 256 + 1, dtype=torch.int64, device=dev)
    # Both wait for the device: the scalar's copy from pageable memory and
    # the host reads.
    with span("sync"):
        seen[torch.where(valid, rows * 256 + rank, B * 256)] = 1
        ngroups = int(seen[: B * 256].sum())
        total = int(n64.sum())
        max_n = int(n64.max())

    k = 1
    while True:
        shifted = torch.gather(rank, 1, torch.where(valid, (idx + k) % nsafe, 0))
        key = row_hi | (rank << _RANK_BITS) | torch.where(valid, shifted, _PAD)
        key_s, order = torch.sort(key.reshape(-1))
        key_s = key_s.reshape(B, N)
        order = order.reshape(B, N) - row_base          # position in row
        is_head = torch.ones((B, N), dtype=torch.bool, device=dev)
        is_head[:, 1:] = key_s[:, 1:] != key_s[:, :-1]
        group = row_cumsum(is_head) - 1
        rank = torch.empty_like(rank).scatter_(1, order, group)
        rank = torch.where(valid, rank, _PAD)
        # Sorted slots below n hold the real rotations.
        new_groups = read_int((is_head & valid).sum())
        k *= 2
        if new_groups in (ngroups, total) or k >= max_n:
            break
        ngroups = new_groups

    # bwt[j] = block[(sa[j] + n - 1) mod n] with sa = the final order.
    prev = torch.where(valid, (order + n64 - 1) % nsafe, 0)
    bwt = torch.where(valid, torch.gather(block, 1, prev), 0).to(torch.uint8)
    ptr = ((rank < rank[:, :1]) & valid).sum(dim=1)
    return bwt, ptr
