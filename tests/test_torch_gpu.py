"""banzai_tpu_torch's CUDA kernels vs their plain PyTorch versions, on the
card.  Every test here is marked ``gpu`` and skips without a CUDA device.

This file imports no JAX, so it runs on a machine that has none:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q
"""

import bz2
import io
import random

import numpy as np
import pytest
import torch

import banzai_tpu_torch
from banzai_tpu_torch.encoder_host import compress as host_compress
from banzai_tpu_torch import _build
from banzai_tpu_torch.ops.compact_kernel import (
    compact_stream, compact_stream_plain,
)
from banzai_tpu_torch.ops.huffman import plan_entropy, plan_entropy_plain
from banzai_tpu_torch.ops.mtf_kernel import mtf_shuffle, mtf_shuffle_plain
from banzai_tpu_torch.ops.stream_kernels import (
    PACK_TILE, RLE2_TILE, pack_words_batch, pack_words_batch_plain,
    rle2_expand_batch, rle2_expand_batch_plain,
)
from banzai_tpu_torch.pipeline import EncodeStats, _padded_len

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("C,K", [(1000, 64), (37, 100), (5, 7), (300, 1024),
                                 (40, 2048), (9, 1030)])
def test_mtf_shuffle_kernel_matches_plain(cuda, C, K):
    rng = np.random.default_rng(C + K)
    syms = rng.integers(0, 256, (C, K)).astype(np.int32)
    syms[rng.random((C, K)) < 0.1] = -1                     # pad lanes
    state0 = np.stack([rng.permutation(256) for _ in range(C)]).astype(np.int32)
    s = torch.from_numpy(syms).to(cuda)
    st = torch.from_numpy(state0).to(cuda)
    before = _build.LAUNCHES["mtf_shuffle"]
    got = mtf_shuffle(s, st, debug_checks=True)
    assert _build.LAUNCHES["mtf_shuffle"] == before + 1
    torch.testing.assert_close(got, mtf_shuffle_plain(s, st), rtol=0, atol=0)


def test_mtf_shuffle_kernel_debug_catches_duplicate(cuda):
    st = torch.arange(256, dtype=torch.int32, device=cuda).repeat(2, 1)
    st[1, 1] = 0
    with pytest.raises(AssertionError, match="invariant"):
        mtf_shuffle(torch.zeros((2, 8), dtype=torch.int32, device=cuda), st,
                    debug_checks=True)


@pytest.mark.parametrize("B", [2, 8])
def test_mtf_kernel_at_the_chosen_chunk(cuda, B):
    """The main path's chunk (``ops.mtf.CHUNK``) on real chunk states:
    kernel against plain with the debug checks, and ``mtf_indices`` on
    the card against the CPU at chunk 64."""
    from banzai_tpu_torch.ops.mtf import CHUNK, mtf_indices, shuffle_inputs

    rng = np.random.default_rng(B)
    N = 20_000
    walk = np.cumsum(rng.integers(-2, 3, (B, N)), axis=1) & 0xFF
    bwt = torch.from_numpy(walk.astype(np.uint8))
    ns = torch.tensor([N - 37 * b for b in range(B)])
    present = torch.zeros((B, 256), dtype=torch.bool)
    for b in range(B):
        present[b, bwt[b, : int(ns[b])].long()] = True
    want = mtf_indices(bwt, ns, present, 64)
    K = CHUNK
    got = mtf_indices(bwt.to(cuda), ns.to(cuda), present.to(cuda), K)
    assert torch.equal(got.cpu(), want)

    s, st = shuffle_inputs(bwt.to(cuda), ns.to(cuda), present.to(cuda), K)
    torch.testing.assert_close(mtf_shuffle(s, st, debug_checks=True),
                               mtf_shuffle_plain(s, st, debug_checks=True),
                               rtol=0, atol=0)


def _mtf_like(rng, B, N):
    raw = np.where(rng.random((B, N)) < 0.6, 0, rng.integers(1, 200, (B, N)))
    raw[0, : N // 2] = 0                                    # one long run
    return raw.astype(np.int32)


T = RLE2_TILE
LEVEL1_N = _padded_len(1)
# (B, N, true lengths or None for N in every row): the first two are the
# per-entry kernel's old cases; then one tile exactly (M = N + 1 = T) and
# one lane either side, two tiles, rows ending inside a tile, and the
# scheduler's batches at level 1.
RLE2_CASES = [
    (3, 20000, [20000, 19000, 7]), (3, 20000, [1, 2, 3]),
    (2, T - 1, None), (2, T - 2, None), (2, T, None), (2, 2 * T - 1, None),
    (3, 3 * T, [T + 1, 2 * T - 1, 2 * T]),
    (2, LEVEL1_N, None), (8, LEVEL1_N, None), (64, LEVEL1_N, None),
]


@pytest.mark.parametrize("B,N,ns", RLE2_CASES)
def test_rle2_expand_batch_kernel_matches_plain(cuda, B, N, ns):
    rng = np.random.default_rng(B * N + len(ns or []))
    idx = _mtf_like(rng, B, N)
    if B > 1:
        idx[1, 100 : 100 + min(N - 100, 3 * T + 77)] = 0    # over 3 tiles
    ns = torch.tensor(ns or [N - 13 * b for b in range(B)], device=cuda)
    idx = torch.from_numpy(idx).to(cuda)
    idx = torch.where(torch.arange(N, device=cuda)[None, :] < ns[:, None],
                      idx, -1).to(torch.int32)               # -1 past n
    names = torch.tensor([200, 31, 5] * (B // 3 + 1), device=cuda)[:B]
    before = _build.LAUNCHES["rle2_expand"]
    syms, out_len = rle2_expand_batch(idx, ns, names)
    assert _build.LAUNCHES["rle2_expand"] == before + 1
    want_syms, want_len = rle2_expand_batch_plain(idx, ns, names)
    assert torch.equal(out_len, want_len)
    assert torch.equal(syms, want_syms)


P = PACK_TILE
LEVEL1_E = 2 + (LEVEL1_N + 50) // 50 + 6 * (1 + 3 * 258) + LEVEL1_N + 1
# (kind, B, E): the old per-entry cases, lengths of 32 across tiles,
# tile-sized rows and one entry either side, and the level-1 batches.
PACK_CASES = [
    ("mixed", 2, 5000), ("pileup", 2, 5000), ("overflow", 2, 5000),
    ("len32", 2, 3 * P + 5), ("mixed", 2, P), ("mixed", 2, P - 1),
    ("mixed", 2, P + 1), ("sparse", 1, 2 * P),
    ("mixed", 2, LEVEL1_E), ("mixed", 8, LEVEL1_E), ("mixed", 64, LEVEL1_E),
]


@pytest.mark.parametrize("kind,B,E", PACK_CASES)
def test_pack_words_batch_kernel_matches_plain(cuda, kind, B, E):
    rng = np.random.default_rng(len(kind) + B + E)
    if kind == "pileup":
        lens = np.zeros((B, E), np.int64)
        lens[:, 0], lens[:, -1] = 7, 13
    elif kind == "len32":
        lens = np.where(rng.random((B, E)) < 0.5, 32,
                        rng.integers(0, 33, (B, E)))
    elif kind == "sparse":
        lens = np.where(rng.random((B, E)) < 0.9, 0,
                        rng.integers(1, 33, (B, E)))
    else:
        lens = rng.integers(0, 33 if kind == "overflow" else 18, (B, E))
    vals = torch.from_numpy(
        rng.integers(0, 1 << 32, (B, E), dtype=np.int64)).to(cuda)
    lens = torch.from_numpy(lens.astype(np.int64)).to(cuda)
    bits = int(lens.sum(1).max())
    nwords = bits // (64 if kind == "overflow" else 32) + 2
    before = _build.LAUNCHES["pack_words"]
    words, total = pack_words_batch(vals, lens, nwords)
    assert _build.LAUNCHES["pack_words"] == before + 1
    want_words, want_total = pack_words_batch_plain(vals, lens, nwords)
    assert torch.equal(total, want_total)
    assert torch.equal(words, want_words)
    if kind == "overflow":
        assert int(total.max()) > nwords * 32


@pytest.mark.parametrize("n,tile,density", [
    (512, 512, 0.0), (4096, 512, 0.05), (65536, 512, 0.5),
    (1 << 20, 512, 1.0), (4096, 32, 0.3), (8192, 1024, 0.7),
])
def test_compact_stream_kernel_matches_plain(cuda, n, tile, density):
    rng = np.random.default_rng(n + tile)
    mask = torch.from_numpy(rng.random(n) < density).to(cuda)
    pay = torch.from_numpy(
        rng.integers(-(1 << 31), 1 << 31, n).astype(np.int32)).to(cuda)
    before = _build.LAUNCHES["compact_stream"]
    got, count = compact_stream(mask, pay, tile)
    assert _build.LAUNCHES["compact_stream"] == before + 1
    want, want_count = compact_stream_plain(mask, pay, tile)
    assert int(count) == int(want_count) == int(mask.sum())
    assert torch.equal(got, want)


def test_compress_on_card_matches_host(cuda):
    rng = random.Random(3)
    data = rng.randbytes(150_000) + b"abcde" * 20_000 + bytes(50_000)
    _build.LAUNCHES.clear()
    stats = EncodeStats()
    out = banzai_tpu_torch.compress(data, 1, device="cuda", stats=stats)
    assert out == host_compress(data, 1, jobs=1)
    assert bz2.decompress(out) == data
    assert stats.device_blocks >= 2
    assert all(_build.LAUNCHES[k] > 0
               for k in ("mtf_shuffle", "rle2_expand", "pack_words"))


def test_encode_and_hybrid_on_card_match_host(cuda):
    rng = random.Random(4)
    data = rng.randbytes(250_000) + b"xyz" * 30_000
    want = host_compress(data, 1, jobs=1)
    w = io.BytesIO()
    n = banzai_tpu_torch.encode(io.BytesIO(data), w, 1, "cuda",
                                span_bytes=70_000)
    assert n == len(w.getvalue()) and w.getvalue() == want
    stats = EncodeStats()
    assert banzai_tpu_torch.compress(data, 1, "cuda", stats,
                                     hybrid_jobs=2) == want
    assert stats.host_hybrid >= 1


def test_repeated_compress_reuses_device_memory(cuda):
    # One compute stream per device for the process: the caching
    # allocator reuses a block only on the stream it was allocated on.
    from banzai_tpu_torch import pipeline

    data = random.Random(5).randbytes(300_000)
    banzai_tpu_torch.compress(data, 1, "cuda")
    reserved = torch.cuda.memory_reserved()
    streams = pipeline._streams(torch.device("cuda", 0))
    for _ in range(3):
        banzai_tpu_torch.compress(data, 1, "cuda")
    assert pipeline._streams(torch.device("cuda", 0)) == streams
    assert torch.cuda.memory_reserved() < 2 * reserved


def test_device_ms_marks_timed_stages_and_gaps(cuda):
    """Two calls into one ``EncodeStats``: each batch's timed stages on
    the card's clock, and the gaps between batches, the call's first
    included; a call without stats marks no stage and leaves the next
    call's first gap out."""
    data = random.Random(9).randbytes(250_000) + b"abcde" * 30_000
    stats = EncodeStats()
    for _ in range(2):
        out = banzai_tpu_torch.compress(data, 1, "cuda", stats, batch=2)
        assert out == host_compress(data, 1, jobs=1)
    assert stats.batches >= 4
    dm = stats.device_ms
    assert set(dm) == {"bwt", "plan", "gap", "gap_starved"}
    assert all(v >= 0 for v in dm.values())
    assert dm["gap_starved"] <= dm["gap"]
    assert {"sync", "dispatch", "device_wait_staged"} <= set(stats.host_ms)
    assert set(stats.cpu_ms) == {"dispatch"}

    from banzai_tpu_torch import pipeline
    free = pipeline._FREE_EVENTS[0]
    spare = len(free)
    last = pipeline._LAST_END[0]
    assert banzai_tpu_torch.compress(data, 1, "cuda", batch=2) == out
    assert pipeline._LAST_END[0] is last
    assert len(free) >= spare           # every event came back
    again = EncodeStats()
    banzai_tpu_torch.compress(data, 1, "cuda", again, batch=2)
    assert again.batches == stats.batches // 2
    # The first batch's gap follows a call these stats did not see.
    assert 0 < again.device_ms["bwt"]
    gaps = EncodeStats()
    banzai_tpu_torch.compress(data, 1, "cuda", gaps, batch=2)
    banzai_tpu_torch.compress(data, 1, "cuda", gaps, batch=2)
    assert gaps.device_ms["gap"] > again.device_ms["gap"] >= 0


MAIN_KERNELS = ("mtf_shuffle", "rle2_expand", "pack_words", "entropy_plan")


def test_two_device_threads_on_one_card_match_host(cuda):
    data = random.Random(6).randbytes(300_000) + b"xyz" * 40_000
    _build.LAUNCHES.clear()
    stats = EncodeStats()
    out = banzai_tpu_torch.compress(data, 1, ["cuda:0", "cuda:0"], stats,
                                    batch=1)
    assert out == host_compress(data, 1, jobs=1)
    assert bz2.decompress(out) == data
    assert len(stats.device_batches) == 2
    assert sum(stats.device_batches) == stats.batches == stats.device_blocks
    assert all(_build.LAUNCHES[k] > 0 for k in MAIN_KERNELS)


def test_two_ranks_on_the_card_match_compress(cuda, tmp_path):
    from banzai_tpu_torch.parallel._worker import run_ranks

    data = random.Random(7).randbytes(250_000) + b"abcde" * 30_000
    src, dst = tmp_path / "in.bin", tmp_path / "out.bz2"
    src.write_bytes(data)
    n = torch.cuda.device_count()
    lines = run_ranks(str(src), str(dst), 1,
                      [f"cuda:{r % n}" for r in range(2)], timeout=600)
    assert dst.read_bytes() == banzai_tpu_torch.compress(data, 1, "cuda")
    assert bz2.decompress(dst.read_bytes()) == data
    for ln in lines:
        assert all(ln["launches"].get(k, 0) > 0 for k in MAIN_KERNELS), ln


def test_spbwt_two_shards_on_the_card_match_bwt(cuda):
    """One block's BWT over 2 shards on the card: the bytes and ptr of the
    one-device BWT on the same card and of the NumPy oracle."""
    from banzai_tpu_torch.oracle import numpy_bwt
    from banzai_tpu_torch.ops.bwt import bwt_rotations
    from banzai_tpu_torch.parallel.spbwt import bwt_rotations_sharded

    rng = np.random.default_rng(8)
    data = np.concatenate([
        rng.integers(0, 4, 60_000), np.resize([7, 7, 7, 7, 9], 40_000),
        rng.integers(0, 256, 30_003)]).astype(np.uint8)
    n, N = len(data), 1 << 17
    block = np.zeros(N, np.uint8)
    block[:n] = data
    dev_block = torch.from_numpy(block).to(cuda)
    got, ptr = bwt_rotations_sharded(dev_block, n, devices=["cuda:0"] * 2)
    assert [s.device.type for s in got] == ["cuda", "cuda"]
    want, want_ptr = bwt_rotations(dev_block[None],
                                   torch.tensor([n], device=cuda))
    torch.testing.assert_close(torch.cat(got)[:n], want[0, :n], rtol=0,
                               atol=0)
    ref_bwt, ref_ptr = numpy_bwt(data)
    assert int(ptr) == int(want_ptr[0]) == ref_ptr
    np.testing.assert_array_equal(torch.cat(got)[:n].cpu().numpy(), ref_bwt)


# -- K5: the entropy plan ----------------------------------------------------

PLAN_KEYS = ("num_tables", "tables", "selectors", "sel_mtf_idx",
             "total_bits", "nseg_used", "banzai_split")
PLAN_KERNELS = ("plan_zero_kernel", "plan_hist_kernel", "plan_init_kernel",
                "plan_assign_kernel", "plan_pm_kernel", "plan_mtf_kernel",
                "plan_score_kernel")


def _plan_row(rng, kind: str, M: int):
    """(int32 [M] RLE2 symbols, out_len, num_syms) of one row."""
    row = np.full(M, 258, np.int32)
    if kind == "pad":                   # a padded row: one byte 0
        row[:2] = [0, 2]
        return row, 2, 3
    if kind == "empty":
        return row, 0, 3
    if kind == "flat":                  # equal frequencies: every tie
        n = 258 * (M // 258 // 2)
        row[:n] = np.arange(n) % 258
        return row, n, 258
    ns, n = {"ns3": (3, M), "ns258": (258, M - 7), "x50": (97, 50 * (M // 100)),
             "oneseg": (30, 37)}.get(kind, (int(rng.integers(3, 259)),
                                            int(rng.integers(M // 2, M + 1))))
    p = rng.dirichlet(np.full(ns - 1, 0.3))
    row[: n - 1] = rng.choice(ns - 1, n - 1, p=p)
    row[n - 1] = ns - 1
    return row, n, ns


EDGE_KINDS = ("ns3", "ns258", "flat", "empty", "x50", "oneseg", "pad")


@pytest.mark.parametrize("B,real,nseg,mix", [
    (1, 1, 18_001, "random"), (4, 3, 18_001, "random"),
    (8, 8, 18_001, "random"), (8, 8, 18_001, "edge"),
    (64, 64, 2_001, "edge"), (4, 3, 2_001, "edge"),
])
def test_entropy_plan_kernel_matches_plain(cuda, B, real, nseg, mix):
    """Every field of the kernel's dict equals the plain version's,
    bitwise, on random rows or the edge rows (then random ones); rows
    past ``real`` are padded as the scheduler pads a batch."""
    rng = np.random.default_rng(B * 7 + nseg)
    M = nseg * 50 - 17                  # the last segment part-filled
    edge = list(EDGE_KINDS) if mix == "edge" else []
    kinds = (edge + ["random"] * real)[:real] + ["pad"] * (B - real)
    rows = [_plan_row(rng, k, M) for k in kinds]
    syms = torch.from_numpy(np.stack([r for r, _, _ in rows])).to(cuda)
    out_len = torch.tensor([n for _, n, _ in rows], dtype=torch.int32,
                           device=cuda)
    ns = torch.tensor([k for _, _, k in rows], dtype=torch.int64, device=cuda)
    before = _build.LAUNCHES["entropy_plan"]
    got = plan_entropy(syms, out_len, ns, nseg)
    assert _build.LAUNCHES["entropy_plan"] == before + 1
    want = plan_entropy_plain(syms, out_len, ns, nseg)
    torch.cuda.synchronize()
    assert set(got) == set(want) == set(PLAN_KEYS)
    for key in PLAN_KEYS:
        g, w = got[key], want[key]
        assert (g.shape, g.dtype, g.device) == (w.shape, w.dtype, w.device), key
        assert torch.equal(g, w), (key, kinds)


def test_compress_runs_every_plan_through_the_kernel(cuda):
    rng = random.Random(13)
    data = (rng.randbytes(120_000) + b"the quick brown fox " * 12_000
            + bytes(60_000) + rng.randbytes(30_000))
    _build.LAUNCHES.clear()
    stats = EncodeStats()
    out = banzai_tpu_torch.compress(data, 1, device="cuda", stats=stats,
                                    batch=2)
    assert out == host_compress(data, 1, jobs=1)
    assert bz2.decompress(out) == data
    assert stats.batches >= 2
    assert _build.LAUNCHES["entropy_plan"] == stats.batches
    assert stats.plan_kernel_blocks == stats.device_blocks >= 3


def test_plan_stage_launches_only_its_own_kernels(cuda, tmp_path,
                                                 monkeypatch):
    """Under torch.profiler, over one ``encode_batch_rows``: every kernel
    that the plan stage launches is one of ``entropy_plan.cu``'s, 13 in
    all.  The stage's call is fenced by synchronisations and 20 ms sleeps,
    so the card runs nothing else from 20 ms before the call's profiler
    range to 20 ms after it."""
    import json
    import time

    from torch.profiler import ProfilerActivity, profile, record_function

    from banzai_tpu_torch import block
    from banzai_tpu_torch.pipeline import _nwords, stage_rows
    from banzai_tpu_torch.rle1 import iter_blocks

    rng = random.Random(14)
    data = rng.randbytes(150_000) + b"abcabd" * 40_000
    blocks = [b.output for b in iter_blocks(data, 1)][:3]
    N = _padded_len(1)
    nseg = (N + 1 + 49) // 50
    rows = stage_rows(blocks, N, 4)[0].to(cuda)
    plan = block.plan_entropy

    def fenced(*args):
        torch.cuda.synchronize()
        time.sleep(0.02)
        with record_function("plan_call"):
            out = plan(*args)
        torch.cuda.synchronize()
        time.sleep(0.02)
        return out

    monkeypatch.setattr(block, "plan_entropy", fenced)
    block.encode_batch_rows(rows, nseg=nseg, nwords=_nwords(N, nseg))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        block.encode_batch_rows(rows, nseg=nseg, nwords=_nwords(N, nseg))
        torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X"]
    call = [e for e in events if e["name"] == "plan_call"
            and e.get("cat") == "user_annotation"]
    assert len(call) == 1
    lo = call[0]["ts"] - 10_000                 # µs
    hi = call[0]["ts"] + call[0]["dur"] + 10_000
    inside = [e["name"] for e in events
              if e.get("cat") == "kernel" and lo <= e["ts"] <= hi]
    assert len(inside) == 13, inside
    assert all(any(k in n for k in PLAN_KERNELS) for n in inside), inside
