"""Within-block sharded BWT: one block's rotation sort over a list of devices.

Counterpart of ``banzai_tpu/parallel/spbwt.py``'s ``bwt_rotations_sharded``
(its ``lane_mesh`` has none: the caller names the devices, resolved by
``parallel.dp.block_devices``): the wrap-around BWT and ``ptr`` of one block,
byte for byte those of ``ops/bwt.bwt_rotations``, with the rotation sort
split lane-wise over D devices so that no device ever holds an O(N)
tensor.  It is the long-context capability, for blocks larger than one
card: a bzip2 block (at most 900 KB) fits one card many times over, and
neither ``compress`` nor ``encode`` calls this module.

Shard d holds positions [d*m, (d+1)*m), m = N / D.  The device list may
repeat a device (D shards on one card, or on the CPU).  One round of
prefix doubling with shift k:

* the shifted rank ``rank[(p + k) mod n]`` is a uniform shift: shard d's
  window of at most m lanes comes from at most three source shards,
  counting the wrap at n (which may fall inside a shard), and exactly
  those slices are copied to shard d's device.  The JAX module rolls
  whole shards through ppermute stages instead;
* (rank, shifted rank) pack into one int64 key, 32 bits each; every shard
  sorts its lanes, then an odd-even merge-split of the shards (D rounds)
  sorts them globally.  Each pair's 2m lanes are sorted once, on the
  lower device, and the upper half is copied to the partner (the JAX
  module sorts on both partners, which must then see the identical
  concatenation);
* a lane's payload is its position and the byte before it,
  ``(p << 8) | block[(p - 1) mod n]``, carried through the sorts by their
  indices, so the last round's order gives the BWT column directly;
* new ranks are dense group numbers: a cumsum of group heads per shard
  plus the exclusive prefix sum of the D shards' head counts, gathered on
  the first device and sent back; the head test at a shard's first lane
  reads the previous shard's last key;
* the ranks go back to position space by a scatter: each destination
  shard takes every shard's (position, rank) lanes in turn and keeps those
  in its range (the JAX module runs a second merge-split keyed by
  position).

The loop reads one count a round, the number of groups among the n real
rotations, and stops when every rotation is a group of its own, when a
round splits no group (the remaining ties are identical rotations, as on
periodic input), or when the prefix covers the whole rotation.  It
compares group counts, not resolved lanes: a round can split a tie group
into smaller tie groups without resolving a lane.

The JAX module starts from a 7-byte prefix and resolves tandem-repeat
chains of period <= 6 in closed form.  Both only cut the number of
rounds, and the port's one-device BWT (``ops/bwt.py``) has neither.  This
module is plain doubling from 1-byte ranks, as ``ops/bwt.py`` is: the
same bytes and ``ptr`` as the JAX module, in more rounds on periodic
input.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch

from .dp import Devices, block_devices

_PAD = torch.iinfo(torch.int64).max   # key of the lanes past n: last of all
_MAX_N = 1 << 31                      # a rank must fit in 32 bits of the key


def _shards(block: torch.Tensor | Sequence[torch.Tensor],
            devs: list[torch.device]) -> list[torch.Tensor]:
    """``block`` as D uint8 [m] shards, shard d on ``devs[d]``."""
    D = len(devs)
    if isinstance(block, torch.Tensor):
        if block.dim() != 1 or block.numel() % D:
            raise ValueError(f"block of shape {tuple(block.shape)} does not "
                             f"split into {D} equal shards")
        m = block.numel() // D
        shards = [block[d * m:(d + 1) * m].to(dev)
                  for d, dev in enumerate(devs)]
    else:
        shards = list(block)
        if len(shards) != D:
            raise ValueError(f"{len(shards)} shards for {D} devices")
        m = shards[0].numel()
        for d, (s, dev) in enumerate(zip(shards, devs)):
            if s.dim() != 1 or s.numel() != m or s.device != dev:
                raise ValueError(f"shard {d}: shape {tuple(s.shape)} on "
                                 f"{s.device}, want [{m}] on {dev}")
    if m < 1 or any(s.dtype != torch.uint8 for s in shards):
        raise ValueError("shards must be non-empty uint8 tensors")
    return shards


def _window(ranks: list[torch.Tensor], d: int, n: int, k: int,
            out: torch.Tensor) -> None:
    """``out[i] = rank[(d*m + i + k) mod n]`` for shard d's real positions,
    copied slice by slice from the shards that hold them."""
    m = ranks[0].numel()
    v = min(m, n - d * m)
    src, i = (d * m + k) % n, 0
    while i < v:
        e, off = divmod(src, m)
        t = min(v - i, m - off, n - src)
        out[i:i + t].copy_(ranks[e][off:off + t], non_blocking=True)
        i += t
        src = (src + t) % n


def _merge_split(keys: list[torch.Tensor], lanes: list[torch.Tensor],
                 devs: list[torch.device]) -> None:
    """Odd-even transposition of locally sorted shards, in place: after D
    rounds the shards, in order, hold one sorted sequence.  Each half is
    copied out of the pair's 2m lanes, so a shard keeps m lanes."""
    D, m = len(keys), keys[0].numel()
    for r in range(D):
        for lo in range(r % 2, D - 1, 2):
            hi, dev = lo + 1, devs[lo]
            key, order = torch.sort(torch.cat(
                [keys[lo], keys[hi].to(dev, non_blocking=True)]))
            lane = torch.cat(
                [lanes[lo], lanes[hi].to(dev, non_blocking=True)])[order]
            keys[lo], lanes[lo] = key[:m].clone(), lane[:m].clone()
            keys[hi] = key[m:].to(devs[hi], non_blocking=True, copy=True)
            lanes[hi] = lane[m:].to(devs[hi], non_blocking=True, copy=True)


def _relabel(keys: list[torch.Tensor],
             devs: list[torch.device]) -> tuple[list[torch.Tensor], int]:
    """Dense group numbers of the globally sorted lanes, and the number of
    groups (the lanes past n, if any, are the last group)."""
    cums = []
    for d, key in enumerate(keys):
        head = torch.empty(key.shape, dtype=torch.bool, device=key.device)
        head[1:] = key[1:] != key[:-1]
        if d:
            head[:1] = key[:1] != keys[d - 1][-1:].to(key.device)
        else:
            head[:1] = True
        cums.append(torch.cumsum(head, 0))
    counts = torch.stack([c[-1].to(devs[0]) for c in cums])
    before = torch.cumsum(counts, 0) - counts
    ranks = [c + (before[d] - 1).to(c.device) for d, c in enumerate(cums)]
    return ranks, int(counts.sum())


def _to_positions(lanes: list[torch.Tensor], ranks: list[torch.Tensor],
                  devs: list[torch.device]) -> list[torch.Tensor]:
    """Sorted-space ranks back to position space: shard e scatters every
    shard's lanes in turn, those outside its range into one spill lane."""
    m = lanes[0].numel()
    out = []
    for e, dev in enumerate(devs):
        got = torch.empty(m + 1, dtype=torch.int64, device=dev)
        for lane, rank in zip(lanes, ranks):
            p = (lane.to(dev, non_blocking=True) >> 8) - e * m
            p = torch.where((p >= 0) & (p < m), p, m)
            got.scatter_(0, p, rank.to(dev, non_blocking=True))
        out.append(got[:m])
    return out


def bwt_rotations_sharded(
    block: torch.Tensor | Sequence[torch.Tensor],
    n: int | torch.Tensor,
    *,
    devices: Devices,
    debug_rounds: bool = False,
):
    """Wrap-around BWT of ``block[:n]`` with the sort sharded over
    ``devices``, D entries.

    Args:
      block: uint8 [N] (N a multiple of D), or D uint8 [m] shards with
        shard d already on ``devices[d]``.
      n: true length, 1 <= n <= N < 2^31.
      debug_rounds: also return the rank coverage k at which the doubling
        loop stopped (a power of two, at most the next one >= n).
    Returns:
      (bwt, ptr) or (bwt, ptr, k): ``bwt`` is D uint8 [m] shards, each on
      its device, whose concatenation's first n bytes are the BWT column
      (zeros past n); ``ptr`` is an int64 scalar tensor on the first
      device, the number of rotations strictly smaller than rotation 0.
    """
    devs = block_devices(devices)
    shards = _shards(block, devs)
    D, m = len(devs), shards[0].numel()
    N, n = D * m, int(n)
    if not 1 <= n <= N:
        raise ValueError(f"n = {n} outside 1..{N}")
    if N >= _MAX_N:
        raise ValueError(f"block length {N} needs more than 31 rank bits")
    i64 = torch.int64
    pos = [torch.arange(d * m, (d + 1) * m, device=dev, dtype=i64)
           for d, dev in enumerate(devs)]
    real = [p < n for p in pos]      # also: sorted slot < n

    # Payloads (position << 8 | preceding byte) and the 1-byte ranks.
    e, off = divmod(n - 1, m)
    before_first = shards[e][off:off + 1]       # block[n - 1]
    pays = []
    for d, (s, dev) in enumerate(zip(shards, devs)):
        prev = torch.empty(m, dtype=i64, device=dev)
        prev[1:] = s[:-1]
        prev[:1] = (shards[d - 1][-1:] if d else before_first).to(dev)
        pays.append((pos[d] << 8) | prev)
    ranks = [s.to(i64) for s in shards]
    seen = sum(torch.bincount(r[:max(0, min(m, n - d * m))], minlength=256)
               .to(devs[0]) for d, r in enumerate(ranks))
    groups = int((seen > 0).sum())
    pad_group = int(n < N)

    k = 1
    while True:
        keys, lanes = [], []
        for d, dev in enumerate(devs):
            shifted = torch.zeros(m, dtype=i64, device=dev)
            _window(ranks, d, n, k % n, shifted)
            key, order = torch.sort(
                torch.where(real[d], (ranks[d] << 32) | shifted, _PAD))
            keys.append(key)
            lanes.append(pays[d][order])
        _merge_split(keys, lanes, devs)
        sorted_ranks, total = _relabel(keys, devs)
        new_groups = total - pad_group
        k *= 2
        if new_groups in (groups, n) or k >= n:
            break
        groups = new_groups
        ranks = _to_positions(lanes, sorted_ranks, devs)

    bwt = [torch.where(r, lane & 0xFF, 0).to(torch.uint8)
           for r, lane in zip(real, lanes)]
    # ptr: the lanes ranked below rotation 0's group (the lanes past n are
    # ranked above every real one).
    r0 = torch.stack([torch.where(lane >> 8 == 0, rank, 0).sum().to(devs[0])
                      for lane, rank in zip(lanes, sorted_ranks)]).sum()
    ptr = torch.stack([(rank < r0.to(rank.device)).sum().to(devs[0])
                       for rank in sorted_ranks]).sum()
    if debug_rounds:
        return bwt, ptr, k
    return bwt, ptr
