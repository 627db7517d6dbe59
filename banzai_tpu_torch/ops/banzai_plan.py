"""The device half of banzai's quirk-exact entropy plan, batched over blocks.

Counterpart of ``banzai_tpu/ops/banzai_plan.py`` (``_initial_partition``
and ``banzai_split_device``).  Only the matmul-shaped half runs on the
device: the initial-partition cost sweep and the per-table segment
frequency split.  The sequential heap builds that turn the split into
banzai's exact bit count run on the host
(``huffman_host.banzai_bits_from_split``).
"""

from __future__ import annotations

import torch

from ..constants import MAX_SYMS as S

_BIG = 1e9
# Banzai never uses more than 3 tables (its table count is keyed on the
# alphabet size <= 258).
_BNT = 3


def _initial_partition(
    freqs: torch.Tensor, ns: torch.Tensor, input_size: torch.Tensor,
    nt: torch.Tensor,
) -> torch.Tensor:
    """Banzai's pseudo tables: contiguous ~equal-frequency symbol ranges,
    15 in range and 0 out, with the odd-interior backtrack.  freqs [B, S],
    ns / input_size / nt [B].  Returns int64 [B, _BNT, S]."""
    dev = freqs.device
    sym_ids = torch.arange(S, device=dev, dtype=torch.int64)[None, :]
    ns = ns.to(torch.int64)
    nt = nt.to(torch.int64)
    cum = torch.cumsum(
        torch.where(sym_ids < ns[:, None], freqs.to(torch.int64), 0), dim=1
    )
    sym_left = torch.zeros_like(ns)
    freq_remaining = input_size.to(torch.int64)
    rows = []
    for t in range(_BNT):
        empty = sym_left >= ns
        target = freq_remaining // torch.clamp(nt - t, min=1)
        base = torch.where(
            sym_left > 0,
            torch.gather(cum, 1, torch.clamp(sym_left - 1, min=0)[:, None])[:, 0],
            0,
        )
        acc_s = cum - base[:, None]
        hit = (
            (sym_ids >= sym_left[:, None]) & (acc_s >= target[:, None])
            & (sym_ids < ns[:, None])
        )
        first = hit.to(torch.int32).argmax(dim=1)            # first True
        sym_right = torch.where(
            hit.any(dim=1), torch.minimum(first, ns - 1), ns - 1
        )
        # Only an interior odd table shrinks by one symbol: t == 1, nt == 3.
        do_bt = (t == 1) & (nt == 3) & (sym_right > sym_left)
        sym_right = torch.where(do_bt, sym_right - 1, sym_right)
        acc = torch.gather(cum, 1, sym_right[:, None])[:, 0] - base
        in_range = (
            (sym_ids >= sym_left[:, None]) & (sym_ids <= sym_right[:, None])
            & ~empty[:, None]
        )
        rows.append(torch.where(in_range, 15, 0))
        sym_left = torch.where(empty, sym_left, sym_right + 1)
        freq_remaining = torch.where(
            empty, freq_remaining, freq_remaining - acc
        )
    return torch.stack(rows, dim=1)


def banzai_split(
    hist: torch.Tensor, freqs: torch.Tensor, out_len: torch.Tensor,
    num_syms: torch.Tensor,
) -> torch.Tensor:
    """Banzai's iteration-0 table split: int64 [B, _BNT, S].

    hist float32 [B, NSEG, S] segment histograms, freqs [B, S] (their
    column sums), out_len and num_syms [B].  Each segment goes to the
    cheapest pseudo table (first of equal costs), and the split is each
    table's summed segment histogram."""
    dev = hist.device
    ns = num_syms.to(torch.int64)
    nt = torch.where(ns < 200, 2, 3)
    pseudo = _initial_partition(freqs, ns, out_len, nt)     # [B, _BNT, S]
    t_ids = torch.arange(_BNT, device=dev)
    costs = hist @ pseudo.to(torch.float32).transpose(1, 2)  # [B, NSEG, _BNT]
    costs = costs + torch.where(t_ids[None, :] < nt[:, None], 0.0, _BIG)[
        :, None, :
    ]
    sel0 = torch.argmin(costs, dim=-1)                      # first-wins
    onehot = (sel0[..., None] == t_ids).to(torch.float32)   # [B, NSEG, _BNT]
    return (onehot.transpose(1, 2) @ hist).to(torch.int64)
