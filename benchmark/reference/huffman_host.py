"""Production entropy stage (host/NumPy reference implementation).

Frozen copy of the host module of the same name in the port, for the
benchmark's plain reference: NumPy only, no C helpers, and nothing of
the program imported.

Design goals (SURVEY.md §7): strictly better compression than the banzai
model so that output size <= banzai at every level, with an algorithm whose
hot parts are matrix-shaped (segment-histogram x length-table products) and
therefore map directly onto the TPU implementation in ops/huffman.py.

Differences from both banzai and reference bzip2:

* Code lengths come from boundary package-merge — *optimal* length-limited
  (<=17 bit) codes, instead of heuristic frequency-halving
  (lib/huffman.rs:271-298).
* Group refinement uses the correct bzip2 semantics (fresh per-iteration
  frequency accumulators, cheap-in-range initial tables), not banzai's
  quirks (SURVEY.md §2.5).
* The table count is chosen *adaptively*: refinement is run for every
  num_tables in 2..6 plus a degenerate single-table candidate, and the
  candidate with the fewest total bits (selectors + table deltas + payload)
  wins.  This dominates both banzai's alphabet-keyed choice and bzip2's
  MTF-length thresholds.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .bitio import BitWriter
from .constants import CODEWORD_MAX_LEN, SEGMENT_WIDTH


# ---------------------------------------------------------------------------
# Optimal length-limited code lengths: boundary package-merge
# ---------------------------------------------------------------------------

def pm_code_lengths(
    freqs: np.ndarray, limit: int = CODEWORD_MAX_LEN
) -> np.ndarray:
    """Package-merge optimal code lengths with max length ``limit``.

    Weights-only formulation (no per-leaf count matrices): the forward
    pass builds each level's package weights; the backward pass walks the
    chosen-count recurrence c_{l-1} = 2 * (#packages among the first c_l
    merged items).  A leaf's length is the number of levels at which it is
    chosen, and since leaves are weight-sorted that is simply
    ``#{levels l : leaf_rank < x_l}`` where ``x_l`` is the number of
    chosen leaves at level l.  Ties order leaves before packages (stable
    merge), matching the device twin bit-for-bit.

    Zero frequencies are clamped to 1 (every symbol needs a code in the
    bzip2 table format).  Returns uint8 lengths in [1, limit].
    """
    w = np.maximum(np.asarray(freqs, dtype=np.int64), 1)
    n = len(w)
    if n == 1:
        return np.ones(1, dtype=np.uint8)
    order = np.argsort(w, kind="stable")
    ws = w[order]

    # Forward: per level, the merged (weight, is_package) lists.
    merged_levels = []
    pair_w = np.zeros(0, dtype=np.int64)
    for _ in range(limit):
        mw = np.concatenate((ws, pair_w))
        tag = np.concatenate(
            (np.zeros(n, np.int64), np.ones(len(pair_w), np.int64))
        )
        srt = np.lexsort((tag, mw))          # weight asc, leaves first
        mw = mw[srt]
        tag = tag[srt]
        merged_levels.append(tag)
        m = len(mw) & ~1
        pair_w = mw[0:m:2] + mw[1:m:2]

    # Backward: chosen counts per level.
    x = np.zeros(limit, dtype=np.int64)      # chosen leaves per level
    c = 2 * n - 2
    for l in range(limit - 1, -1, -1):
        tag = merged_levels[l]
        c = min(c, len(tag))
        p = int(tag[:c].sum())               # chosen packages
        x[l] = c - p
        c = 2 * p
    lengths_sorted = (np.arange(n)[:, None] < x[None, :]).sum(axis=1)
    lengths = np.empty(n, dtype=np.uint8)
    lengths[order] = lengths_sorted.astype(np.uint8)
    return lengths


# ---------------------------------------------------------------------------
# Refinement driver (correct bzip2 semantics, matrix-shaped)
# ---------------------------------------------------------------------------

def segment_histogram(syms: np.ndarray, num_syms: int) -> np.ndarray:
    """Per-50-symbol-segment histogram matrix [nseg, num_syms]."""
    syms = np.asarray(syms, dtype=np.int64)
    n = len(syms)
    nseg = (n + SEGMENT_WIDTH - 1) // SEGMENT_WIDTH
    hist = np.zeros((nseg, num_syms), dtype=np.int64)
    np.add.at(hist, (np.arange(n) // SEGMENT_WIDTH, syms), 1)
    return hist


def _initial_tables(freqs: np.ndarray, num_syms: int, nt: int) -> np.ndarray:
    """Contiguous ~equal-frequency partition; in-range symbols cheap (0),
    out-of-range expensive (15).  Closed-form owner rule shared with the
    device twin (ops/huffman.initial_tables): symbol s belongs to table
    floor((cumfreq_incl(s)-1) * nt / total)."""
    f = np.maximum(np.asarray(freqs[:num_syms], dtype=np.int64), 0)
    cum = np.cumsum(f)
    total = max(int(cum[-1]), 1)
    owner = np.clip((np.maximum(cum - 1, 0) * nt) // total, 0, nt - 1)
    tables = np.where(
        owner[None, :] == np.arange(nt)[:, None], 0, 15
    ).astype(np.int64)
    return tables


def refine_tables(
    hist: np.ndarray, freqs: np.ndarray, num_syms: int, nt: int,
    iterations: int = 4,
) -> tuple[np.ndarray, np.ndarray]:
    """Greedy table/selector refinement with fresh accumulators per sweep.

    Returns (tables[nt, num_syms] uint8 lengths, selectors[nseg] int64).
    The cost sweep is one [nseg, num_syms] @ [num_syms, nt] product —
    the MXU-shaped hot op on device.
    """
    tables = _initial_tables(freqs, num_syms, nt)
    selectors = np.zeros(len(hist), dtype=np.int64)
    # float32 matmul is exact here (all values are small integers) and hits
    # BLAS on host / the MXU on device.
    hist_f = hist.astype(np.float32)
    for _ in range(iterations):
        costs = hist_f @ tables.T.astype(np.float32)   # [nseg, nt]
        selectors = np.argmin(costs, axis=1)           # first-wins on ties
        new_tables = np.empty_like(tables)
        for t in range(nt):
            tf = hist[selectors == t].sum(axis=0)
            new_tables[t] = pm_code_lengths(tf)
        tables = new_tables
    return tables.astype(np.uint8), selectors


# ---------------------------------------------------------------------------
# Exact bit-cost accounting and candidate selection
# ---------------------------------------------------------------------------

def iter_selector_mtf(selectors, num_tables: int):
    """Yield each selector's MTF stack index — the ONE stack walk shared by
    cost accounting (selector_bits) and emission (write_selectors), so the
    planner's objective can never silently diverge from the bits written."""
    stack = list(range(num_tables))
    for sel in selectors:
        idx = stack.index(int(sel))
        if idx:
            stack.pop(idx)
            stack.insert(0, int(sel))
        yield idx


def selector_bits(selectors: np.ndarray, nt: int) -> int:
    """Unary-MTF cost of the selector list (lib/huffman.rs:471-503)."""
    return sum(i + 1 for i in iter_selector_mtf(selectors, nt))


def table_delta_bits(tables: np.ndarray) -> int:
    """Delta-coding cost: 5 + per symbol 2*|delta| + 1."""
    t = np.asarray(tables, dtype=np.int64)
    deltas = np.abs(np.diff(t, axis=1)).sum(axis=1)
    # First symbol: acc starts at t[0] so its delta is 0.
    return int((5 + t.shape[1] + 2 * deltas).sum())


def payload_bits(
    hist: np.ndarray, tables: np.ndarray, selectors: np.ndarray
) -> int:
    lens = np.asarray(tables, dtype=np.int64)
    return int((hist * lens[selectors]).sum())


@dataclass
class EntropyPlan:
    num_tables: int
    tables: np.ndarray      # uint8 [nt, num_syms]
    selectors: np.ndarray   # int64 [nseg]
    total_bits: int         # excl. the 3+15 fixed header bits


def plan_entropy(
    syms: np.ndarray, num_syms: int, freqs: np.ndarray,
    include_banzai: bool = True,
    table_counts: tuple[int, ...] = (2, 3, 4, 5, 6),
) -> EntropyPlan:
    """Pick the cheapest candidate across table counts.

    ``table_counts`` are the refined multi-table candidates; the port
    runs all five.  The benchmark's control passes fewer.

    ``include_banzai`` (default ON for every block) adds the reference's
    quirk-exact plan as one more candidate.  Banzai's heap trees can land
    a delta-coding-cheaper length assignment than the payload-optimal
    package-merge tree (Huffman trees are not unique; fuzz seed 33 iter
    145 found a 29-byte block where that wins by a byte), and the
    north-star size contract is "<= banzai on EVERY input" — which this
    closes by construction: min over a candidate set that contains
    banzai's exact plan can never exceed banzai.  The device planner
    carries the same candidate (ops/banzai_plan.banzai_plan_device), so
    host/device twins stay bit-identical on every block.
    """
    hist = segment_histogram(syms, num_syms)
    candidates: list[EntropyPlan] = []

    # Degenerate single-table candidate: selectors never leave table 0, so
    # the mandatory second table (format minimum num_tables == 2,
    # lib/huffman.rs:106-112) is a constant all-15s dummy — the cheapest
    # possible delta coding (5 + num_syms bits).  Duplicating the optimal
    # table here would pay its delta cost twice and can lose to banzai's
    # collapsed 2-table plans (found by fuzz iter 201, seed 0).
    single = pm_code_lengths(freqs)
    dummy = np.full_like(single, 15)
    stables = np.stack([single, dummy])
    ssel = np.zeros(len(hist), dtype=np.int64)
    candidates.append(
        EntropyPlan(
            2, stables, ssel,
            selector_bits(ssel, 2)
            + table_delta_bits(stables)
            + payload_bits(hist, stables, ssel),
        )
    )

    # Same candidate set as the device twin (ops/huffman.NT_CANDIDATES).
    for nt in table_counts:
        tables, selectors = refine_tables(hist, freqs, num_syms, nt)
        bits = (
            selector_bits(selectors, nt)
            + table_delta_bits(tables)
            + payload_bits(hist, tables, selectors)
        )
        candidates.append(EntropyPlan(nt, tables, selectors, bits))

    if include_banzai:
        from .banzai_model import banzai_entropy_plan

        bnt, btab, bsel = banzai_entropy_plan(
            np.asarray(syms, dtype=np.int64), num_syms, freqs
        )
        bt = np.asarray(btab, dtype=np.uint8)
        bs = np.asarray(bsel, dtype=np.int64)
        # Appended LAST: our candidates win ties, so existing streams only
        # change where banzai's plan is strictly smaller.
        candidates.append(
            EntropyPlan(
                bnt, bt, bs,
                selector_bits(bs, bnt)
                + table_delta_bits(bt)
                + payload_bits(hist, bt, bs),
            )
        )

    return min(candidates, key=lambda c: c.total_bits)


# ---------------------------------------------------------------------------
# The <=-banzai contract check for device-encoded blocks
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# Emission (shared format-level helpers)
# ---------------------------------------------------------------------------

def canonical_codes(lengths: np.ndarray) -> np.ndarray:
    """uint32 codewords per symbol, canonical (length, symbol) order
    (format per lib/huffman.rs:547-561).  Vectorized."""
    lengths = np.asarray(lengths, dtype=np.int64)
    # Sort by (length, symbol); assign sequential words per length with a
    # left shift between length steps: word = (count of shorter-or-earlier).
    order = np.lexsort((np.arange(len(lengths)), lengths))
    sorted_lens = lengths[order]
    words = np.zeros(len(lengths), dtype=np.int64)
    word = 0
    prev_len = sorted_lens[0]
    for rank, s in enumerate(order):       # <=258 iterations, host-trivial
        l = sorted_lens[rank]
        word <<= (l - prev_len)
        words[s] = word
        word += 1
        prev_len = l
    return words.astype(np.uint32)


def write_selectors(bw: BitWriter, selectors, num_tables: int) -> None:
    """Selectors, MTF + unary coded (format per lib/huffman.rs:471-503)."""
    for idx in iter_selector_mtf(selectors, num_tables):
        idx = int(idx)
        bw.write_bits((1 << (idx + 1)) - 2, idx + 1)


def write_table_deltas(bw: BitWriter, table) -> None:
    """Delta-coded code lengths (format per lib/huffman.rs:505-545)."""
    acc = int(table[0])
    bw.write_bits(acc, 5)
    for l in table:
        l = int(l)
        while l != acc:
            if l > acc:
                bw.write_bits(2, 2)
                acc += 1
            else:
                bw.write_bits(3, 2)
                acc -= 1
        bw.write_bits(0, 1)


def write_entropy(
    bw: BitWriter, syms: np.ndarray, plan: EntropyPlan
) -> None:
    bw.write_bits(plan.num_tables, 3)
    # 15-bit format field (lib/huffman.rs:470); level 9's max is ~18,003
    # segments (900,096/50) — guard the edge so a capacity change can't
    # silently wrap it.
    assert len(plan.selectors) < (1 << 15), "num_selectors overflows 15 bits"
    bw.write_bits(len(plan.selectors), 15)
    write_selectors(bw, plan.selectors.tolist(), plan.num_tables)
    code_words = []
    for t in range(plan.num_tables):
        write_table_deltas(bw, plan.tables[t].tolist())
        code_words.append(canonical_codes(plan.tables[t]))
    # Payload: vectorized codeword lookup + numpy bit pack, then splice.
    from .bitio import pack_bits_numpy

    syms = np.asarray(syms, dtype=np.int64)
    sel_per_sym = plan.selectors[np.arange(len(syms)) // SEGMENT_WIDTH]
    words = np.stack(code_words)[sel_per_sym, syms].astype(np.uint64)
    lens = plan.tables[sel_per_sym, syms].astype(np.uint64)
    packed, nbits = pack_bits_numpy(words, lens)
    bw.splice_words(packed, nbits)
