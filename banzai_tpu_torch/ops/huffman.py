"""Entropy planning, batched over blocks: package-merge + group refinement.

Counterpart of ``banzai_tpu/ops/huffman.py`` (``segment_view`` ..
``plan_entropy_device``).  Every function takes a leading batch dimension
where the JAX version was vmapped.  ``plan_entropy`` launches kernel K5
(``plan_kernel.entropy_plan``, integer arithmetic throughout) for CUDA
tensors and runs ``plan_entropy_plain`` for CPU tensors.  The plain
version's float32 products carry integers whose sums stay below 2^24, so
they are exact only while float32 matrix products run in full float32:
``plan_entropy_plain`` sets and checks that (no TF32).
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import (
    CODEWORD_MAX_LEN, MAX_SYMS as S, MAX_TABLES as T, SEGMENT_WIDTH,
)

from ..spans import span
from .banzai_plan import banzai_split
from .plan_kernel import entropy_plan

NT_CANDIDATES = (2, 3, 4, 5, 6)
_INF_W = 1 << 29    # > any finite package weight (sum of freqs)

# The 2..6-table candidates' tables flattened onto one [_K] axis: column k
# belongs to candidate _COL_CAND[k], table _COL_TABLE[k]; candidate c owns
# columns [_COL_LO[c], _COL_LO[c + 1]).
_K = sum(NT_CANDIDATES)                                       # 20
_COL_CAND = np.concatenate(
    [np.full(nt, ci) for ci, nt in enumerate(NT_CANDIDATES)]
)
_COL_TABLE = np.concatenate([np.arange(nt) for nt in NT_CANDIDATES])
_COL_LO = np.concatenate([[0], np.cumsum(NT_CANDIDATES)]).tolist()


def exact_float32_matmul() -> None:
    """Make float32 matrix products run in full float32 and check it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("TF32 matmul is on: plan products would round")
    if torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError("float32 matmul precision is not 'highest'")


def segment_view(x: torch.Tensor, nseg: int, fill) -> torch.Tensor:
    """Pad (with ``fill``) or truncate [B, M] to [B, nseg, SEGMENT_WIDTH]."""
    B, M = x.shape
    L = nseg * SEGMENT_WIDTH
    if M >= L:
        xp = x[:, :L]
    else:
        xp = torch.cat(
            [x, torch.full((B, L - M), fill, dtype=x.dtype, device=x.device)],
            dim=1,
        )
    return xp.reshape(B, nseg, SEGMENT_WIDTH)


def segment_hist(
    syms: torch.Tensor, out_len: torch.Tensor, nseg: int
) -> torch.Tensor:
    """float32 [B, nseg, S] symbol counts of each 50-symbol segment, as a
    scatter-add over (block, segment, symbol).  Slots at or past
    ``out_len`` count in a spill column S that is dropped."""
    B, M = syms.shape
    dev = syms.device
    pos = torch.arange(M, device=dev)[None, :]
    live = pos < out_len.to(torch.int64)[:, None]
    sym_p = segment_view(torch.where(live, syms.to(torch.int64), S), nseg, S)
    seg_base = torch.arange(B * nseg, device=dev).reshape(B, nseg, 1) * (S + 1)
    hist = torch.zeros(B * nseg * (S + 1), dtype=torch.int32, device=dev)
    hist.scatter_add_(
        0, (seg_base + sym_p).reshape(-1),
        torch.ones(sym_p.numel(), dtype=torch.int32, device=dev),
    )
    return hist.reshape(B, nseg, S + 1)[:, :, :S].to(torch.float32)


def pm_lengths(freqs: torch.Tensor, num_syms: torch.Tensor) -> torch.Tensor:
    """Package-merge code lengths, 17-bit limited, over the last axis.

    freqs: integer [..., S] (total < 2^29); num_syms: [...] alphabet sizes
    (3..258), broadcastable to freqs.shape[:-1].  Returns int64 [..., S]:
    lengths in [1, 17] for s < num_syms, else 0.  The leaf sort is stable
    (ties keep symbol order), which decides which of two equal-weight
    leaves gets which length.
    """
    L = CODEWORD_MAX_LEN
    dev = freqs.device
    sym_ids = torch.arange(S, device=dev, dtype=torch.int64)
    ns = num_syms.to(torch.int64)[..., None]
    w = torch.where(
        sym_ids < ns, torch.clamp(freqs.to(torch.int64), min=1), _INF_W
    )
    ws, worder = torch.sort(w, dim=-1, stable=True)

    # Each level sorts (weight, tag) packed as one key: tag 0 = leaf sorts
    # before tag 1 = package at equal weight.
    leaf_k = ws << 1
    pair_w = torch.full_like(ws, _INF_W)
    tag_cum_levels = []
    for _ in range(L):
        mk = torch.sort(torch.cat([leaf_k, (pair_w << 1) | 1], dim=-1),
                        dim=-1).values                          # [..., 2S]
        tag_cum_levels.append(torch.cumsum(mk & 1, dim=-1))
        mw = mk >> 1
        pair_w = torch.clamp(mw[..., 0::2] + mw[..., 1::2], max=_INF_W)
    tag_cum = torch.stack(tag_cum_levels, dim=-2)               # [..., L, 2S]

    # Backward chosen-count recurrence: c_{l-1} = 2 * packages among the
    # first c_l items of level l.
    c = (2 * ns[..., 0] - 2).expand(ws.shape[:-1]).contiguous()
    x = torch.zeros(ws.shape[:-1] + (L,), dtype=torch.int64, device=dev)
    for l in range(L - 1, -1, -1):
        cum = torch.gather(
            tag_cum[..., l, :], -1, torch.clamp(c - 1, min=0)[..., None]
        )[..., 0]
        p = torch.where(c > 0, cum, 0)
        x[..., l] = c - p
        c = 2 * p

    # A leaf's length is the number of levels at which it is chosen.
    lens_sorted = (sym_ids[:, None] < x[..., None, :]).sum(dim=-1)
    lens = torch.empty_like(lens_sorted).scatter_(-1, worder, lens_sorted)
    return torch.where(sym_ids < ns, lens, 0)


def initial_tables(freqs: torch.Tensor, num_syms: torch.Tensor) -> torch.Tensor:
    """Initial partition lengths of all candidates: int64 [B, _K, S].

    Symbol s goes to table floor((cumfreq_incl(s) - 1) * nt / total); in
    range it costs 0, otherwise 15 (the host rule of
    huffman_host._initial_tables)."""
    dev = freqs.device
    sym_ids = torch.arange(S, device=dev, dtype=torch.int64)
    ns = num_syms.to(torch.int64)[:, None]
    f = torch.where(sym_ids < ns, torch.clamp(freqs.to(torch.int64), min=0), 0)
    cum = torch.cumsum(f, dim=-1)
    total = torch.clamp(cum[:, -1:], min=1)
    out = []
    for nt in NT_CANDIDATES:
        owner = torch.clamp((torch.clamp(cum - 1, min=0) * nt) // total,
                            0, nt - 1)                          # [B, S]
        t_ids = torch.arange(nt, device=dev)[None, :, None]
        out.append(torch.where(owner[:, None, :] == t_ids, 0, 15))
    return torch.cat(out, dim=1)


def selector_mtf(
    sel: torch.Tensor, nseg_used: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Unary-MTF indices and total bits of selector sequences.

    sel: integer [..., NSEG]; nseg_used: [...].  Returns (idx int64
    [..., NSEG], bits int64 [...]), in closed form from each table's last
    occurrence (no sequential scan)."""
    nseg = sel.shape[-1]
    dev = sel.device
    sel = sel.to(torch.int64)
    seg_pos = torch.arange(nseg, device=dev, dtype=torch.int64)
    t_ids = torch.arange(T, device=dev, dtype=torch.int64)
    marked = torch.where(sel[..., None] == t_ids, seg_pos[:, None], -1)
    last_incl = torch.cummax(marked, dim=-2).values            # [..., NSEG, T]
    last = torch.cat(
        [torch.full_like(last_incl[..., :1, :], -1), last_incl[..., :-1, :]],
        dim=-2,
    )                                                           # exclusive
    prev = torch.gather(last, -1, sel[..., None])[..., 0]
    seen = last >= 0
    idx_seen = (last > prev[..., None]).sum(dim=-1)
    n_seen = seen.sum(dim=-1)
    n_seen_lt = (seen & (t_ids < sel[..., None])).sum(dim=-1)
    idx = torch.where(prev >= 0, idx_seen, n_seen + sel - n_seen_lt)
    live = seg_pos < nseg_used.to(torch.int64)[..., None]
    bits = ((idx + 1) * live).sum(dim=-1)
    return idx, bits


def table_delta_bits(tables: torch.Tensor, num_syms: torch.Tensor) -> torch.Tensor:
    """Delta-coding cost of table sets [..., T, S]: int64 [...]; only
    symbols below ``num_syms`` [...] emit."""
    dev = tables.device
    t = tables.to(torch.int64)
    ns = num_syms.to(torch.int64)[..., None]
    d = torch.abs(t[..., 1:] - t[..., :-1])
    col = torch.arange(1, S, device=dev)
    d = torch.where(col < ns[..., None], d, 0)
    per_table = 5 + ns + 2 * d.sum(dim=-1)
    return per_table.sum(dim=-1)


def plan_entropy(
    syms: torch.Tensor, out_len: torch.Tensor,
    num_syms: torch.Tensor, nseg: int,
) -> dict:
    """Full candidate search for every block of the batch.

    syms int32 [B, M] RLE2 symbols, out_len [B], num_syms [B].  Returns
    the winning plan per block (num_tables [B], tables [B, T, S],
    selectors [B, nseg], sel_mtf_idx [B, nseg], total_bits [B], nseg_used
    [B]) plus banzai's table split [B, 3, S], all int64.

    One CUDA entry point (kernel K5) for CUDA tensors, which raises on any
    other device; the plain version for CPU tensors."""
    if syms.device.type == "cpu":
        return plan_entropy_plain(syms, out_len, num_syms, nseg)
    return entropy_plan(syms, out_len, num_syms, nseg)


def plan_entropy_plain(
    syms: torch.Tensor, out_len: torch.Tensor,
    num_syms: torch.Tensor, nseg: int,
) -> dict:
    """Plain version of ``plan_entropy``: the segment histogram, 4
    refinement iterations of float32 products and package-merge sorts,
    the selector MTF in closed form, and banzai's split."""
    exact_float32_matmul()
    dev = syms.device
    B = syms.shape[0]
    ns = num_syms.to(torch.int64)
    out_len = out_len.to(torch.int64)
    hist = segment_hist(syms, out_len, nseg)                 # [B, NSEG, S]
    freqs = hist.sum(dim=1).to(torch.int64)                  # exact: < 2^24
    nseg_used = (out_len + SEGMENT_WIDTH - 1) // SEGMENT_WIDTH

    with span("sync"):          # copies from pageable memory wait for the stream
        col_cand = torch.as_tensor(_COL_CAND, device=dev)
        col_table = torch.as_tensor(_COL_TABLE, device=dev)
    NC = len(NT_CANDIDATES)
    tables = initial_tables(freqs, ns).to(torch.float32)     # [B, K, S]
    for it in range(4):
        costs = hist @ tables.transpose(1, 2)                # [B, NSEG, K]
        sel = torch.stack([
            torch.argmin(costs[:, :, _COL_LO[ci] : _COL_LO[ci + 1]], dim=-1)
            for ci in range(NC)
        ], dim=1)                                            # [B, NC, NSEG]
        onehot = (sel[:, col_cand, :] == col_table[None, :, None]).to(
            torch.float32
        )                                                    # [B, K, NSEG]
        tf = onehot @ hist                                   # [B, K, S]
        pm_in = tf.to(torch.int64)
        if it == 3:
            pm_in = torch.cat([pm_in, freqs[:, None]], dim=1)
        lens = pm_lengths(pm_in, ns[:, None])
        tables = lens[:, :_K].to(torch.float32)
        if it == 3:
            single = lens[:, _K]                             # [B, S]
    tables_i = tables.to(torch.int64)                        # [B, K, S]

    sel_idx, sel_bits = selector_mtf(sel, nseg_used[:, None])  # [B, NC, ..]
    sym_hi = torch.arange(1, S, device=dev)
    d = torch.abs(tables_i[..., 1:] - tables_i[..., :-1])
    d = torch.where(sym_hi < ns[:, None, None], d, 0)
    per_col = 5 + ns[:, None] + 2 * d.sum(dim=-1)            # [B, K]
    # tf is the final selection's per-table histogram: payload per column.
    pay_col = (tf.to(torch.int64) * tables_i).sum(dim=-1)    # [B, K]
    delta_bits = torch.stack(
        [per_col[:, _COL_LO[c] : _COL_LO[c + 1]].sum(-1) for c in range(NC)],
        dim=1,
    )
    payload = torch.stack(
        [pay_col[:, _COL_LO[c] : _COL_LO[c + 1]].sum(-1) for c in range(NC)],
        dim=1,
    )
    bits_multi = sel_bits + delta_bits + payload             # [B, NC]

    # Single-table candidate: selectors stay on table 0; the mandatory
    # second table is an all-15s dummy (cheapest delta coding).
    sym_ids = torch.arange(S, device=dev)
    dummy = torch.where(sym_ids < ns[:, None], 15, 0)        # [B, S]
    stables = torch.cat(
        [single[:, None], dummy[:, None].expand(B, T - 1, S)], dim=1
    )
    s_sel = torch.zeros((B, nseg), dtype=torch.int64, device=dev)
    s_idx, s_selbits = selector_mtf(s_sel, nseg_used)
    sd = torch.abs(single[:, 1:] - single[:, :-1])
    sd = torch.where(sym_hi < ns[:, None], sd, 0)
    s_delta = (5 + ns + 2 * sd.sum(-1)) + (5 + ns)
    s_payload = (freqs * single).sum(-1)
    bits_single = s_selbits + s_delta + s_payload

    b_split = banzai_split(hist, freqs, out_len, ns)

    # Pick the winner (first of equal totals).
    all_bits = torch.cat([bits_single[:, None], bits_multi], dim=1)
    win = torch.argmin(all_bits, dim=1)                      # [B]
    with span("sync"):
        all_nt = torch.tensor([2, *NT_CANDIDATES], device=dev)
    cand_tables = torch.stack([
        torch.cat([
            tables_i[:, _COL_LO[c] : _COL_LO[c + 1]],
            torch.zeros((B, T - nt, S), dtype=torch.int64, device=dev),
        ], dim=1)
        for c, nt in enumerate(NT_CANDIDATES)
    ], dim=1)                                                # [B, NC, T, S]
    all_tables = torch.cat([stables[:, None], cand_tables], dim=1)
    all_sel = torch.cat([s_sel[:, None], sel], dim=1)
    all_idx = torch.cat([s_idx[:, None], sel_idx], dim=1)
    rows = torch.arange(B, device=dev)
    return {
        "num_tables": all_nt[win],
        "tables": all_tables[rows, win],
        "selectors": all_sel[rows, win],
        "sel_mtf_idx": all_idx[rows, win],
        "total_bits": all_bits[rows, win],
        "nseg_used": nseg_used,
        "banzai_split": b_split,
    }
