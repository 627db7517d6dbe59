"""Kernel K5's algorithms (``banzai_tpu_torch/csrc/entropy_plan.cu``) as
NumPy models, held against the plain version on the CPU, and the
wrapper's choice of path.

The kernel computes what ``huffman.plan_entropy_plain`` computes, by
other means: package-merge by merging sorted leaves with sorted packages
(leaves first at equal weight) instead of sorting packed keys, the
selector MTF by walking 256 chunks from lists composed of the chunks'
recency summaries instead of the closed form, and segment costs as
integer sums of the segments' symbols' lengths instead of float32
products.  The models below follow the kernel step for step, so the tie
rules of the new algorithms are guarded without a card; the card tests
(``tests/test_torch_gpu.py``) hold the kernel itself to the plain
version.
"""

import numpy as np
import pytest
import torch

from banzai_tpu_torch import _build
from banzai_tpu_torch.constants import (
    CODEWORD_MAX_LEN as L, MAX_SYMS as S, MAX_TABLES as T, SEGMENT_WIDTH as W,
)
from banzai_tpu_torch.huffman_host import iter_selector_mtf
from banzai_tpu_torch.ops import huffman

INF = 1 << 29
NTS = (2, 3, 4, 5, 6)
LO = np.concatenate([[0], np.cumsum(NTS)])      # candidate c: [LO[c], LO[c+1])


def pm_merge(freqs: np.ndarray, ns: int) -> np.ndarray:
    """One row of the kernel's ``plan_pm_kernel``."""
    sym = np.arange(S)
    w = np.where(sym < ns, np.maximum(freqs, 1), INF).astype(np.int64)
    # Stable rank by counting: ties keep symbol order.
    rank = np.array([(w < w[i]).sum() + (w[:i] == w[i]).sum()
                     for i in range(S)])
    leaf = np.empty(S, np.int64)
    order = np.empty(S, np.int64)
    leaf[rank], order[rank] = w, sym
    pkg = np.full(S, INF, np.int64)
    tags = []
    live, fin = min(max(ns, 0), S), 0     # finite leaves and packages
    for _ in range(L):
        lpos = sym + np.searchsorted(pkg, leaf, side="left")    # pkgs < leaf
        ppos = sym + np.searchsorted(leaf, pkg, side="right")   # leaves <= pkg
        # The kernel searches only the finite parts; infinite items' places
        # follow from the counts.
        assert np.array_equal(lpos[:live], sym[:live] + np.searchsorted(
            pkg[:fin], leaf[:live], side="left"))
        assert np.array_equal(ppos[:fin], sym[:fin] + np.searchsorted(
            leaf[:live], pkg[:fin], side="right"))
        assert np.array_equal(lpos[live:], sym[live:] + fin)
        assert np.array_equal(ppos[fin:], sym[fin:] + S)
        merged = np.empty(2 * S, np.int64)
        merged[lpos], merged[ppos] = leaf, pkg
        assert np.array_equal(np.sort(np.concatenate([lpos, ppos])),
                              np.arange(2 * S))
        tag = np.zeros(2 * S, bool)
        tag[ppos] = True
        tags.append(tag)
        pkg = np.minimum(merged[0::2] + merged[1::2], INF)
        fin = (live + fin) // 2
    c, x = 2 * ns - 2, [0] * L
    for lev in reversed(range(L)):
        p = int(tags[lev][: min(c, 2 * S)].sum()) if c > 0 else 0
        x[lev], c = c - p, 2 * p
    out = np.zeros(S, np.int64)
    out[order] = [sum(i < xl for xl in x) for i in range(S)]
    return np.where(sym < ns, out, 0)


def mtf_sequential(sel, used: int):
    """Selector MTF from the list 0..5, one selector after the other."""
    lst, idx, bits = list(range(T)), [], 0
    for p, v in enumerate(sel):
        i = lst.index(v)
        idx.append(i)
        lst.insert(0, lst.pop(i))
        bits += (i + 1) * (p < used)
    return np.array(idx, np.int64), bits


def rec_then(a: list, b: list) -> list:
    """The recency summary (distinct tables, latest use first) of a run
    summarised by ``a`` followed by one summarised by ``b``; with ``a``
    a whole list, the MTF list after ``b``'s run."""
    return b + [v for v in a if v not in b]


def mtf_chunked(sel, used: int, threads: int = 256):
    """The kernel's selector MTF (``plan_mtf_kernel``): thread t
    summarises chunk t (whole 16-selector words), an inclusive scan of the
    summaries in each warp (doubling steps) and over the warps before it
    gives its starting list, and it walks its chunk again from there."""
    n = len(sel)
    size = -(-(-(-n // threads)) // 16) * 16
    bounds = [(min(n, t * size), min(n, t * size + size))
              for t in range(threads)]
    inc = []
    for lo, hi in bounds:
        rec = []
        for p in range(hi - 1, lo - 1, -1):
            if len(rec) == T:
                break
            if sel[p] not in rec:
                rec.append(sel[p])
        inc.append(rec)
    for d in (1, 2, 4, 8, 16):
        inc = [rec_then(inc[t - d], r) if t % 32 >= d else r
               for t, r in enumerate(inc)]
    idx, bits = np.zeros(n, np.int64), 0
    for t, (lo, hi) in enumerate(bounds):
        before = []
        for w in range(t // 32):
            before = rec_then(before, inc[32 * w + 31])
        if t % 32:
            before = rec_then(before, inc[t - 1])
        lst = rec_then(list(range(T)), before)
        for p in range(lo, hi):
            i = lst.index(sel[p])
            idx[p] = i
            lst.insert(0, lst.pop(i))
            bits += (i + 1) * (p < used)
    return idx, bits


def pseudo_tables(cum: np.ndarray, ns: int, out_len: int) -> np.ndarray:
    """``plan_init_kernel``'s banzai pseudo tables, one after the other."""
    ntb = 2 if ns < 200 else 3
    left, rem = 0, out_len
    rows = np.zeros((3, S), np.int64)
    for t in range(3):
        empty = left >= ns
        target = rem // max(ntb - t, 1)
        base = cum[min(max(left - 1, 0), S - 1)] if left > 0 else 0
        hits = [s for s in range(S)
                if s >= left and s < ns and cum[s] - base >= target]
        right = min(hits[0], ns - 1) if hits else ns - 1
        if t == 1 and ntb == 3 and right > left:
            right -= 1
        acc = cum[min(max(right, 0), S - 1)] - base
        if not empty:
            rows[t, left : right + 1] = 15
            left, rem = right + 1, rem - acc
    return rows


def plan_model(syms: np.ndarray, out_len: int, ns: int, nseg: int) -> dict:
    """One block through the kernel's steps."""
    sym = np.arange(S)
    lim = max(0, min(out_len, len(syms), nseg * W))
    lanes = np.full(nseg * W, -1, np.int64)
    lanes[:lim] = np.where((syms[:lim] >= 0) & (syms[:lim] < S),
                           syms[:lim], -1)
    segs = lanes.reshape(nseg, W)
    live = segs >= 0
    freqs = np.bincount(segs[live], minlength=S)

    cum = np.cumsum(np.where(sym < ns, freqs, 0))
    total = max(cum[-1], 1)
    tables = []
    for nt in NTS:
        owner = np.minimum(np.maximum(cum - 1, 0) * nt // total, nt - 1)
        tables += [np.where(owner == t, 0, 15) for t in range(nt)]
    tables = np.array(tables)

    def costs(tabs):        # integer sums of the segments' symbols' lengths
        ext = np.concatenate([tabs, np.zeros((len(tabs), 1), np.int64)], 1)
        return ext[:, segs].sum(axis=2).T               # [nseg, len(tabs)]

    def counts(cols, nrows):
        out = np.zeros(nrows * S, np.int64)
        flat = cols[:, None] * S + segs
        np.add.at(out, flat[live], 1)
        return out.reshape(nrows, S)

    for it in range(4):
        c = costs(tables)
        sel = np.stack([np.argmin(c[:, LO[k] : LO[k + 1]], axis=1)
                        for k in range(5)])             # first of equal
        tf = sum(counts(LO[k] + sel[k], 20) for k in range(5))
        if it == 0:
            ntb = 2 if ns < 200 else 3
            sel0 = np.argmin(costs(pseudo_tables(cum, ns, out_len))[:, :ntb],
                             axis=1)
            split = counts(sel0, 3)
        tables = np.array([pm_merge(tf[k], ns) for k in range(20)])
    single = pm_merge(freqs, ns)

    used = -(-out_len // W)
    delta = [5 + ns + 2 * np.abs(np.diff(t))[: max(ns - 1, 0)].sum()
             for t in tables]
    pay = (tf * tables).sum(axis=1)
    mtf = [mtf_chunked(sel[k], used) for k in range(5)]
    bits = [min(used, nseg) + (5 + ns + 2 * np.abs(np.diff(single))[
        : max(ns - 1, 0)].sum()) + (5 + ns) + (freqs * single).sum()]
    bits += [mtf[k][1] + sum(delta[LO[k] : LO[k + 1]])
             + pay[LO[k] : LO[k + 1]].sum() for k in range(5)]
    win = int(np.argmin(bits))
    out_tables = np.zeros((T, S), np.int64)
    if win == 0:
        out_tables[0] = single
        out_tables[1:] = np.where(sym < ns, 15, 0)
        selectors = idx = np.zeros(nseg, np.int64)
    else:
        k = win - 1
        out_tables[: NTS[k]] = tables[LO[k] : LO[k + 1]]
        selectors, idx = sel[k], mtf[k][0]
    return {"num_tables": [2, *NTS][win], "tables": out_tables,
            "selectors": selectors, "sel_mtf_idx": idx,
            "total_bits": bits[win], "nseg_used": used,
            "banzai_split": split}


# ---------------------------------------------------------------------------


def _tie_heavy(rng, kind: int) -> np.ndarray:
    if kind == 0:
        return np.full(S, 7, np.int64)                        # all equal
    if kind == 1:
        return rng.choice([0, 1, 2, 5], S).astype(np.int64)   # few levels
    if kind == 2:                  # Fibonacci-like: the 17-bit cap binds
        f = np.ones(S, np.int64)
        f[2:40] = [int(1.6 ** k) for k in range(38)]
        return rng.permutation(f)
    return rng.integers(0, 50_000, S)


@pytest.mark.parametrize("seed", range(8))
def test_merge_package_merge_model_matches_pm_lengths(seed):
    rng = np.random.default_rng(seed)
    rows = [(_tie_heavy(rng, (seed + i) % 4), ns)
            for i, ns in enumerate((258, 100, 3, 201, 2))]
    freqs = np.stack([f for f, _ in rows])
    ns = np.array([n for _, n in rows])
    want = huffman.pm_lengths(torch.from_numpy(freqs), torch.from_numpy(ns))
    for b, (f, n) in enumerate(rows):
        np.testing.assert_array_equal(pm_merge(f, n), want[b].numpy())


@pytest.mark.parametrize("n,used,kind", [
    (400, 400, "random"), (18_001, 12_345, "random"), (2_001, 2_001, "runs"),
    (31, 31, "random"), (1, 1, "random"), (100, 0, "zeros"),
    (5_000, 4_999, "few"),
])
def test_selector_mtf_models_match_selector_mtf(n, used, kind):
    rng = np.random.default_rng(n + used)
    if kind == "random":
        sel = rng.integers(0, 6, n)
    elif kind == "runs":
        sel = np.repeat(rng.integers(0, 6, n // 40 + 1), 40)[:n]
    elif kind == "few":
        sel = rng.choice([1, 4], n)
    else:
        sel = np.zeros(n, np.int64)
    idx, bits = huffman.selector_mtf(torch.from_numpy(sel)[None],
                                     torch.tensor([used]))
    for model in (mtf_sequential, mtf_chunked):
        got_idx, got_bits = model(list(sel), used)
        np.testing.assert_array_equal(got_idx, idx[0].numpy())
        assert got_bits == int(bits[0])
    np.testing.assert_array_equal(
        idx[0].numpy(), list(iter_selector_mtf(list(sel), 6)))


def _rle2_row(rng, ns: int, n: int, M: int) -> np.ndarray:
    """RLE2-like symbols in [0, ns - 1) with EOB = ns - 1 at n - 1."""
    row = np.full(M, 258, np.int32)
    if n == 0:
        return row
    p = rng.dirichlet(np.full(ns - 1, 0.3))
    row[: n - 1] = rng.choice(ns - 1, n - 1, p=p)
    row[n - 1] = ns - 1
    return row


def _flat_row(ns: int, n: int, M: int) -> np.ndarray:
    """Every symbol below ns equally often: package-merge and argmin ties."""
    row = np.full(M, 258, np.int32)
    row[:n] = np.arange(n) % ns
    return row


M = 4001
NSEG = (M + W - 1) // W


def _edge_batch():
    rng = np.random.default_rng(11)
    rows = [
        (_rle2_row(rng, 40, M, M), M, 40),
        (_rle2_row(rng, 258, 3000, M), 3000, 258),
        (_rle2_row(rng, 3, 17, M), 17, 3),             # num_syms 3
        (_flat_row(258, 258 * 10, M), 258 * 10, 258),  # all-equal freqs
        (np.full(M, 258, np.int32), 0, 3),             # out_len 0
        (_rle2_row(rng, 120, 50 * 37, M), 50 * 37, 120),  # multiple of 50
        (_rle2_row(rng, 30, 42, M), 42, 30),           # one live segment
        (_flat_row(7, 700, M), 700, 7),
    ]
    # A padded row as the scheduler makes it: one byte 0 -> RUNA, EOB.
    pad = np.full(M, 258, np.int32)
    pad[:2] = [0, 2]
    rows.append((pad, 2, 3))
    syms = np.stack([r for r, _, _ in rows])
    out_len = np.array([o for _, o, _ in rows], np.int32)
    ns = np.array([n for _, _, n in rows], np.int64)
    return syms, out_len, ns


def test_plan_model_matches_plain_on_edge_rows():
    syms, out_len, ns = _edge_batch()
    want = huffman.plan_entropy_plain(torch.from_numpy(syms),
                                      torch.from_numpy(out_len),
                                      torch.from_numpy(ns), NSEG)
    for b in range(len(ns)):
        got = plan_model(syms[b], int(out_len[b]), int(ns[b]), NSEG)
        for key, v in got.items():
            np.testing.assert_array_equal(v, want[key][b].numpy(),
                                          err_msg=f"{key}/{b}")


@pytest.mark.parametrize("seed", range(3))
def test_plan_model_matches_plain_on_random_rows(seed):
    rng = np.random.default_rng(100 + seed)
    cases = [(int(rng.integers(3, 259)), int(rng.integers(1, M + 1)))
             for _ in range(3)]
    syms = np.stack([_rle2_row(rng, ns, n, M) for ns, n in cases])
    out_len = np.array([n for _, n in cases], np.int32)
    ns = np.array([n for n, _ in cases], np.int64)
    want = huffman.plan_entropy_plain(torch.from_numpy(syms),
                                      torch.from_numpy(out_len),
                                      torch.from_numpy(ns), NSEG)
    for b in range(len(cases)):
        got = plan_model(syms[b], int(out_len[b]), int(ns[b]), NSEG)
        for key, v in got.items():
            np.testing.assert_array_equal(v, want[key][b].numpy(),
                                          err_msg=f"{key}/{b}")


def test_wrapper_takes_the_plain_version_for_cpu_tensors(monkeypatch):
    syms, out_len, ns = _edge_batch()
    args = (torch.from_numpy(syms), torch.from_numpy(out_len),
            torch.from_numpy(ns), NSEG)
    calls = []
    plain = huffman.plan_entropy_plain
    monkeypatch.setattr(huffman, "plan_entropy_plain",
                        lambda *a: calls.append(a) or plain(*a))
    before = _build.LAUNCHES["entropy_plan"]
    got = huffman.plan_entropy(*args)
    assert len(calls) == 1 and _build.LAUNCHES["entropy_plan"] == before
    want = plain(*args)
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype == torch.int64
        assert torch.equal(got[key], want[key])


def test_no_fallback_off_the_cpu(monkeypatch):
    """A tensor on any other device reaches the kernel's wrapper, which
    launches or raises: never the plain version."""
    monkeypatch.setattr(huffman, "plan_entropy_plain", None)
    syms = torch.zeros((2, 100), dtype=torch.int32, device="meta")
    z = torch.zeros(2, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="unsupported device meta"):
        huffman.plan_entropy(syms, z.to(torch.int32), z + 3, 2)
