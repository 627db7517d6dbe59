"""RLE2 entry stream: zero-run bijective-base-2 coding as prefix sums.

Counterpart of ``banzai_tpu/ops/rle2.py`` (``rle2_entries``), batched over
blocks.  Maximal runs of MTF index 0 become RUNA/RUNB digit strings (the
bits of run + 1 below its leading one, LSB first); a nonzero index i
becomes symbol i + 1; EOB ends the block.  This is the first half of
K2's plain version (``stream_kernels.rle2_expand_batch_plain``); on the
card, kernel K2 computes the whole function from the MTF indices
(``stream_kernels.rle2_expand_batch``).
"""

from __future__ import annotations

import torch

from ._scan import row_cumsum

_MAX_DIGITS = 20  # zero runs < 2^20 (block <= 900_000)


def rle2_entries(
    mtf_idx: torch.Tensor, n: torch.Tensor, num_names: torch.Tensor
) -> tuple[torch.Tensor, ...]:
    """The entry stream of [B, N] MTF indices with true lengths ``n`` [B].

    One entry per lane of [B, M = N + 1]: a nonzero MTF index, or the EOB
    sentinel at position n.  Entry (off, width, zp1, val) covers output
    slots [off, off + width): ``width - 1`` digits of ``zp1``, then the
    symbol ``val``.  Other lanes have width 0.  Returns int32
    (off, width, zp1, val) [B, M] and out_len [B].
    """
    B, N = mtf_idx.shape
    M = N + 1
    dev = mtf_idx.device
    n = n.to(torch.int64)[:, None]
    pos = torch.arange(M, device=dev, dtype=torch.int64)[None, :]
    is_eob = pos == n
    ext = torch.cat(
        [mtf_idx.to(torch.int64), torch.zeros((B, 1), dtype=torch.int64,
                                              device=dev)], dim=1
    )
    emit = ((ext > 0) & (pos < n)) | is_eob

    # Previous emit position (exclusive cummax).
    marked = torch.where(emit, pos, -1)
    prev = torch.cat(
        [torch.full((B, 1), -1, dtype=torch.int64, device=dev),
         torch.cummax(marked, dim=1).values[:, :-1]], dim=1
    )
    zrun = torch.where(emit, pos - prev - 1, 0)

    # Digit count = bitlength(zrun + 1) - 1, exact by a comparison ladder.
    zp1 = zrun + 1
    nd = torch.zeros_like(zp1)
    for k in range(1, _MAX_DIGITS + 1):
        nd += (zp1 >= (1 << k)).to(torch.int64)

    width = (nd + 1) * emit.to(torch.int64)
    ends = row_cumsum(width)                            # inclusive
    off = ends - width                                  # exclusive
    eob = num_names.to(torch.int64)[:, None] + 1
    val = torch.where(is_eob, eob, ext + 1)
    i32 = torch.int32
    return (off.to(i32), width.to(i32), zp1.to(i32), val.to(i32),
            ends[:, -1].to(i32))
