"""Exact behavioral model of the banzai encoder, quirks included.

Frozen copy of the port's ``oracle/banzai_model.py`` up to the entropy
plan, for the benchmark's plain reference (the plan is one candidate of
``huffman_host.plan_entropy``).

This is the size-parity oracle: the production encoder must emit streams no
larger than this model at every level (BASELINE.md).  It reproduces, per
SURVEY.md §2.5:

* QUIRK #1 — ``num_tables`` chosen from the *alphabet size* (<=258), so it is
  always 2 or 3 (lib/huffman.rs:319-326);
* QUIRK #2 — inverted initial pseudo-lengths (in-range symbols get 15,
  out-of-range 0; lib/huffman.rs:303-304,364-372);
* QUIRK #3 — refinement iterations 1..3 zero the *length* tables while the
  per-table frequency accumulators are never reset, which collapses every
  selector to table 0 (lib/huffman.rs:402-409).

The Huffman tree itself follows the reference's hand-rolled 1-indexed binary
min-heap keyed by (weight, max-leaf-depth) with weight = freq//scaling + 1
and the 17-bit rescale loop (lib/huffman.rs:144-298), replicated so the
model's output sizes match real banzai byte-for-byte.
"""

from __future__ import annotations

import numpy as np

from .constants import CODEWORD_MAX_LEN, SEGMENT_WIDTH


# --- Reference heap/tree replica ------------------------------------------

class _Heap:
    """1-indexed binary min-heap over (sym, (weight, depth)) with the exact
    sift semantics of the reference FrequencyQueue."""

    def __init__(self) -> None:
        self.a: list[tuple[int, tuple[int, int]]] = []

    def insert(self, sym: int, prio: tuple[int, int]) -> None:
        a = self.a
        a.append((sym, prio))
        this = len(a)          # 1-indexed position
        if this == 1:
            return
        init = this
        while True:
            above = this >> 1
            above_sym, above_prio = a[above - 1]
            if prio < above_prio:
                a[this - 1] = (above_sym, above_prio)
                this = above
                if this == 1:
                    break
            else:
                break
        if this != init:
            a[this - 1] = (sym, prio)

    def extract(self) -> tuple[int, tuple[int, int]]:
        a = self.a
        sym, prio = a.pop()
        if not a:
            return (sym, prio)
        root = a[0]
        size = len(a)
        this = 1
        while True:
            left = this << 1
            if left > size:
                break
            right = left + 1
            if right <= size and a[right - 1][1] < a[left - 1][1]:
                below, (bsym, bprio) = right, a[right - 1]
            else:
                below, (bsym, bprio) = left, a[left - 1]
            if prio < bprio:
                break
            a[this - 1] = (bsym, bprio)
            this = below
        a[this - 1] = (sym, prio)
        return root


def banzai_code_lengths(num_syms: int, freqs) -> list[int]:
    """build_table_from_freqs replica (lib/huffman.rs:271-298)."""
    scaling = 1
    while True:
        # Tree arena: root=0, leaves 1..num_syms, inner nodes appended.
        children: list[tuple[int, int] | None] = [None] * (num_syms + 1)
        heap = _Heap()
        for s in range(num_syms):
            heap.insert(s + 1, (freqs[s] // scaling + 1, 0))
        while True:
            one, p1 = heap.extract()
            two, p2 = heap.extract()
            if len(children) == 2 * num_syms - 1:
                children[0] = (one, two)
                break
            children.append((one, two))
            heap.insert(
                len(children) - 1,
                (p1[0] + p2[0], max(p1[1], p2[1]) + 1),
            )
        lengths = [0] * num_syms
        max_len = 0
        stack = [(0, 0)]
        while stack:
            node, depth = stack.pop()
            ch = children[node]
            if ch is not None:
                stack.append((ch[0], depth + 1))
                stack.append((ch[1], depth + 1))
            else:
                lengths[node - 1] = depth
                max_len = max(max_len, depth)
        if max_len <= CODEWORD_MAX_LEN:
            return lengths
        scaling <<= 1


# --- The quirky refinement driver -----------------------------------------

def banzai_entropy_plan(syms, num_syms: int, freqs):
    """The reference's entropy PLAN — (num_tables, tables, selectors) with
    all three verified quirks — without emission.  Besides feeding this
    model's own encoder, it serves as an extra candidate in the production
    planner's tiny-block guard (huffman_host.plan_entropy): banzai's heap
    trees occasionally land a delta-coding-cheaper length assignment than
    the payload-optimal package-merge tree on degenerate blocks (found by
    fuzz seed 33 iter 145: 29 RLE1 bytes, ours 51 > banzai 50), and the
    north star requires output <= banzai on EVERY input.
    """
    input_size = len(syms)
    num_tables = 2 if num_syms < 200 else 3   # QUIRK #1: keyed on alphabet

    # Initial contiguous partition by ~equal total frequency, with the odd
    # interior backtrack, inverted pseudo-lengths (QUIRK #2).
    tables: list[list[int]] = []
    freq_remaining = input_size
    sym_left = 0
    for t in range(num_tables):
        if sym_left >= num_syms:
            # Earlier tables consumed the whole alphabet (extreme skew):
            # the remaining tables get empty ranges instead of indexing
            # past freqs.
            tables.append([0] * num_syms)
            continue
        target = freq_remaining // (num_tables - t)
        acc = 0
        sym_right = sym_left
        while True:
            acc += int(freqs[sym_right])
            if acc >= target or sym_right + 1 == num_syms:
                break
            sym_right += 1
        if (
            sym_right > sym_left
            and t not in (0, num_tables - 1)
            and t % 2 == 1
        ):
            acc -= int(freqs[sym_right])
            sym_right -= 1
        tables.append(
            [15 if sym_left <= s <= sym_right else 0 for s in range(num_syms)]
        )
        sym_left = sym_right + 1
        freq_remaining -= acc

    # Segment histogram matrix, computed once.
    sym_arr = np.asarray(syms, dtype=np.int64)
    nseg = (input_size + SEGMENT_WIDTH - 1) // SEGMENT_WIDTH
    seg_ids = np.arange(input_size) // SEGMENT_WIDTH
    hist = np.zeros((nseg, num_syms), dtype=np.int64)
    np.add.at(hist, (seg_ids, sym_arr), 1)

    table_freqs = np.zeros((num_tables, num_syms), dtype=np.int64)
    selectors: list[int] = []
    for it in range(4):
        final = it == 3
        if it != 0:
            # QUIRK #3: zeroes the LENGTH tables; freqs keep accumulating.
            tables = [[0] * num_syms for _ in range(num_tables)]
        costs = hist @ np.asarray(tables, dtype=np.int64).T   # [nseg, nt]
        best = np.argmin(costs, axis=1)                       # first-wins
        for t in range(num_tables):
            table_freqs[t] += hist[best == t].sum(axis=0)
        if final:
            selectors = best.tolist()
        tables = [
            banzai_code_lengths(num_syms, table_freqs[t]) for t in range(num_tables)
        ]
    return num_tables, tables, selectors
