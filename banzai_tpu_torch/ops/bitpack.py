"""Bitstream assembly by prefix sums, batched over blocks.

Counterpart of ``banzai_tpu/ops/bitpack.py``.  The whole entropy payload
of a block (table count, selector count, unary-MTF selectors, delta-coded
length tables, every codeword) becomes one row of (value, bit length)
entries; an exclusive prefix sum of the lengths gives each entry's bit
offset, and each entry contributes to at most two 32-bit words.
``pack_entries`` (``splice_entries``, then the word assembly) is the plain
version of kernel K3, which computes the same from the entry rows on the
card (``stream_kernels.pack_words_batch``).

uint32 values are held in int64 with explicit ``& 0xFFFFFFFF`` masks.
"""

from __future__ import annotations

import torch

from ..constants import (
    CODEWORD_MAX_LEN, MAX_SYMS as S, MAX_TABLES as T, SEGMENT_WIDTH,
)

from ..spans import span
from ._scan import row_cumsum
from .stream_kernels import pack_words_plain

MASK32 = 0xFFFFFFFF


def canonical_words(tables: torch.Tensor, num_syms: torch.Tensor) -> torch.Tensor:
    """Canonical codewords per (table, symbol): int64 [B, T, S].

    Assignment order is (length, symbol) ascending, in closed form:
    word(s) = first_code[len(s)] + rank of s among same-length symbols."""
    dev = tables.device
    sym_ids = torch.arange(S, device=dev)
    lens = torch.where(
        sym_ids < num_syms.to(torch.int64)[:, None, None],
        tables.to(torch.int64), 0,
    )
    counts = []
    ranks = torch.zeros_like(lens)
    for l in range(1, CODEWORD_MAX_LEN + 1):
        is_l = (lens == l).to(torch.int64)
        counts.append(is_l.sum(dim=-1))
        ranks += torch.where(lens == l, torch.cumsum(is_l, dim=-1) - 1, 0)
    first_codes = [torch.zeros_like(counts[0])]              # length 1
    for l in range(1, CODEWORD_MAX_LEN):
        first_codes.append((first_codes[-1] + counts[l - 1]) << 1)
    fc_table = torch.stack(first_codes, dim=-1)              # [B, T, 17]
    fci = torch.gather(fc_table, -1, torch.clamp(lens - 1, min=0))
    return fci + ranks


def splice_entries(
    vals: torch.Tensor, lens: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-entry word contributions of [B, E] entries.

    Returns (w, hi2, total): entry i contributes the 32-bit field hi2[i]
    (int64 in [0, 2^32)) to word w[i], plus each block's total bit count.
    The rows carry one appended sentinel entry that catches the last real
    entry's spill."""
    B = vals.shape[0]
    dev = vals.device
    zero = torch.zeros((B, 1), dtype=torch.int64, device=dev)
    lens = torch.cat([lens.to(torch.int64), zero], dim=1)
    vals = torch.cat([vals.to(torch.int64) & MASK32, zero], dim=1)
    v = vals & torch.where(lens >= 32, MASK32, (1 << torch.clamp(lens, max=31)) - 1)
    off = row_cumsum(lens) - lens
    total = lens.sum(dim=1)
    w = off >> 5
    b = off & 31
    space = 32 - b
    fits = lens <= space
    hi = torch.where(
        fits,
        (v << (torch.where(fits, space - lens, 0) & 31)) & MASK32,
        v >> torch.where(fits, 0, lens - space),
    )
    lo = torch.where(fits, 0, (v << ((64 - b - lens) & 31)) & MASK32)
    # An entry's spill lands in word w + 1, which is exactly where the next
    # entry starts, below the spill: fold it into the successor's field.
    hi2 = hi | torch.cat([zero, lo[:, :-1]], dim=1)
    return w, hi2, total


def pack_entries(
    vals: torch.Tensor, lens: torch.Tensor, nwords: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Pack [B, E] (value, bit length) entries MSB-first into int32
    [B, nwords] word bit patterns, with the plain word assembly.  Returns
    (words, total bits [B])."""
    w, hi2, total = splice_entries(vals, lens)
    return pack_words_plain(torch.clamp(w, max=nwords), hi2, total, nwords), total


def block_payload_entries(
    syms: torch.Tensor,
    out_len: torch.Tensor,
    num_syms: torch.Tensor,
    num_tables: torch.Tensor,
    tables: torch.Tensor,
    selectors: torch.Tensor,
    sel_mtf_idx: torch.Tensor,
    nseg_used: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The int64 (vals, lens) entry rows [B, E] of each block's payload.

    syms [B, M], tables [B, T, S], selectors and sel_mtf_idx [B, nseg];
    the rest are [B]."""
    B, M = syms.shape
    nseg = selectors.shape[1]
    dev = syms.device
    i64 = torch.int64
    # num_selectors is a 15-bit format field: the static segment capacity
    # bounds nseg_used, so a larger capacity would wrap it silently.
    if nseg >= 1 << 15:
        raise ValueError(f"num_selectors capacity {nseg} overflows 15 bits")
    out_len = out_len.to(i64)
    num_syms = num_syms.to(i64)

    # Header: num_tables (3 bits), num_selectors (15 bits).
    h_vals = torch.stack([num_tables.to(i64), nseg_used.to(i64)], dim=1)
    with span("sync"):          # a copy from pageable memory waits for the stream
        h_lens = torch.tensor([3, 15], dtype=i64, device=dev).expand(B, 2)

    # Selectors: unary MTF codes.
    seg_pos = torch.arange(nseg, device=dev)
    live_seg = seg_pos < nseg_used.to(i64)[:, None]
    sidx = sel_mtf_idx.to(i64)
    s_vals = ((1 << (sidx + 1)) - 2) & MASK32
    s_lens = torch.where(live_seg, sidx + 1, 0)

    # Tables: 5-bit initial length, then per symbol two delta groups and
    # a terminator bit.
    sym_ids = torch.arange(S, device=dev)
    t_ids = torch.arange(T, device=dev)
    t_live = t_ids < num_tables.to(i64)[:, None]             # [B, T]
    s_live = sym_ids < num_syms[:, None]                     # [B, S]
    lens_tab = tables.to(i64)                                # [B, T, S]
    prev = torch.cat([lens_tab[..., :1], lens_tab[..., :-1]], dim=-1)
    d = lens_tab - prev
    dabs = torch.abs(d)
    inc = d > 0
    ga = torch.clamp(dabs, max=8)
    gb = dabs - ga

    def group_pattern(g, is_inc):
        base = ((1 << (2 * g)) - 1) // 3                     # 0b0101..
        return torch.where(is_inc, base * 2, base * 3)

    emit = t_live[:, :, None] & s_live[:, None, :]
    a_vals = group_pattern(ga, inc)
    a_lens = torch.where(emit, 2 * ga, 0)
    b_vals = group_pattern(gb, inc)
    b_lens = torch.where(emit, 2 * gb, 0)
    z_vals = torch.zeros_like(a_vals)
    z_lens = torch.where(emit, 1, 0)
    init_vals = lens_tab[..., 0]
    init_lens = torch.where(t_live, 5, 0)
    per_sym = torch.stack([a_vals, b_vals, z_vals], dim=-1)  # [B, T, S, 3]
    per_sym_l = torch.stack([a_lens, b_lens, z_lens], dim=-1)
    t_vals = torch.cat(
        [init_vals[..., None], per_sym.reshape(B, T, S * 3)], dim=-1
    ).reshape(B, -1)
    t_lens = torch.cat(
        [init_lens[..., None], per_sym_l.reshape(B, T, S * 3)], dim=-1
    ).reshape(B, -1)

    # Payload codewords: a gather from the [T, S] code table by (selector
    # of the slot's segment, symbol).
    words_tab = canonical_words(lens_tab, num_syms)          # [B, T, S]
    packed_tab = ((words_tab << 5) | lens_tab).reshape(B, T * S)
    pos = torch.arange(M, device=dev)[None, :]
    live = pos < out_len[:, None]
    sym_c = torch.where(live, torch.clamp(syms.to(i64), max=S - 1), 0)
    seg = torch.clamp(pos // SEGMENT_WIDTH, max=nseg - 1).expand(B, M)
    sel_slot = torch.gather(selectors.to(i64), 1, seg)
    packed = torch.gather(packed_tab, 1, sel_slot * S + sym_c)
    packed = torch.where(pos < nseg * SEGMENT_WIDTH, packed, 0)
    p_vals = packed >> 5
    p_lens = torch.where(live, packed & 31, 0)

    vals = torch.cat([h_vals, s_vals, t_vals, p_vals], dim=1)
    lens = torch.cat([h_lens, s_lens, t_lens, p_lens], dim=1)
    return vals, lens
