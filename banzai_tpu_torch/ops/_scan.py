"""Row-wise prefix sums for [B, L] tensors with few, long rows."""

from __future__ import annotations

import torch


def row_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum along dim 1 of a [B, L] tensor, as int64.

    One flat scan over all rows, then each row's start is subtracted:
    PyTorch's per-row scan runs one row per block of threads, which leaves
    the card mostly idle on 8 rows of 900,000 lanes."""
    x = x.to(torch.int64)
    cs = torch.cumsum(x.reshape(-1), 0).reshape(x.shape)
    return cs - (cs[:, :1] - x[:, :1])
