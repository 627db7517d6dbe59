"""banzai_tpu_torch entropy plan, banzai split and payload entries vs the
JAX package on the CPU.  Exact equality: every stage is integer, and the
float32 products are exact sums of integers below 2^24."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from banzai_tpu.constants import MAX_SYMS as S
from banzai_tpu.huffman_host import pm_code_lengths
from banzai_tpu.ops import banzai_plan as jbp
from banzai_tpu.ops import bitpack as jbit
from banzai_tpu.ops import huffman as jhuf
from banzai_tpu_torch.ops import banzai_plan, bitpack, huffman

M = 4001          # an RLE2 stream of N = 4000 lanes + EOB
NSEG = (M + 49) // 50


def _stream(seed: int, ns: int, n: int) -> np.ndarray:
    """RLE2-like symbols in [0, ns - 1) with EOB = ns - 1 at n - 1."""
    rng = np.random.default_rng(seed)
    p = rng.dirichlet(np.full(ns - 1, 0.3))
    syms = np.full(M, 258, np.int32)
    syms[: n - 1] = rng.choice(ns - 1, n - 1, p=p)
    syms[n - 1] = ns - 1
    return syms


PLAN_CASES = [(0, 40, M), (1, 258, 3000), (2, 3, 17), (3, 200, M),
              (4, 199, 2500)]


def _plans(cases):
    syms = np.stack([_stream(s, ns, n) for s, ns, n in cases])
    out_len = np.array([n for _, _, n in cases], np.int32)
    ns = np.array([ns for _, ns, _ in cases], np.int32)
    got = huffman.plan_entropy(torch.from_numpy(syms),
                               torch.from_numpy(out_len),
                               torch.from_numpy(ns), NSEG)
    f = jax.jit(partial(jhuf.plan_entropy_device, nseg=NSEG))
    want = [f(jnp.asarray(syms[b]), jnp.int32(out_len[b]), jnp.int32(ns[b]))
            for b in range(len(cases))]
    return syms, out_len, ns, got, want


def test_plan_entropy_every_field_matches_jax():
    _, _, _, got, want = _plans(PLAN_CASES)
    for key in ("num_tables", "tables", "selectors", "sel_mtf_idx",
                "total_bits", "nseg_used", "banzai_split"):
        for b, w in enumerate(want):
            np.testing.assert_array_equal(
                got[key][b].numpy(), np.asarray(w[key]), err_msg=f"{key}/{b}"
            )


def test_block_payload_entries_match_jax():
    syms, out_len, ns, got, _ = _plans(PLAN_CASES[:3])
    vals, lens = bitpack.block_payload_entries(
        torch.from_numpy(syms), torch.from_numpy(out_len),
        torch.from_numpy(ns), got["num_tables"], got["tables"],
        got["selectors"], got["sel_mtf_idx"], got["nseg_used"],
    )
    f = jax.jit(jbit.block_payload_entries)
    for b in range(3):
        vj, lj = f(
            jnp.asarray(syms[b]), jnp.int32(out_len[b]), jnp.int32(ns[b]),
            jnp.asarray(got["num_tables"][b].numpy(), jnp.int32),
            jnp.asarray(got["tables"][b].numpy(), jnp.int32),
            jnp.asarray(got["selectors"][b].numpy(), jnp.int32),
            jnp.asarray(got["sel_mtf_idx"][b].numpy(), jnp.int32),
            jnp.asarray(got["nseg_used"][b].numpy(), jnp.int32),
        )
        np.testing.assert_array_equal(vals[b].numpy(), np.asarray(vj))
        np.testing.assert_array_equal(lens[b].numpy(), np.asarray(lj))


def test_payload_entries_guard_15_bit_selector_count():
    B, nseg = 1, 1 << 15
    z = torch.zeros(B, dtype=torch.int64)
    with pytest.raises(ValueError, match="15 bits"):
        bitpack.block_payload_entries(
            torch.zeros((B, 8), dtype=torch.int32), z + 1, z + 3, z + 2,
            torch.zeros((B, 6, S), dtype=torch.int64),
            torch.zeros((B, nseg), dtype=torch.int64),
            torch.zeros((B, nseg), dtype=torch.int64), z,
        )


def _tie_heavy(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if seed % 3 == 0:
        return np.full(S, 7, np.int64)                   # all equal
    if seed % 3 == 1:
        return rng.choice([0, 1, 2, 5], S).astype(np.int64)  # few levels
    # Fibonacci-like weights force the 17-bit cap.
    f = np.ones(S, np.int64)
    f[2:40] = [int(1.6 ** k) for k in range(38)]
    return rng.permutation(f)


@pytest.mark.parametrize("seed", range(6))
def test_pm_lengths_ties_match_jax_and_host(seed):
    ns_list = [258, 100, 3, 201]
    freqs = np.stack([_tie_heavy(seed + 10 * i) for i in range(4)])
    ns = np.array(ns_list, np.int64)
    got = huffman.pm_lengths(torch.from_numpy(freqs), torch.from_numpy(ns))
    f = jax.jit(jhuf.pm_lengths)
    for b, n in enumerate(ns_list):
        want = np.asarray(f(jnp.asarray(freqs[b], jnp.int32), jnp.int32(n)))
        np.testing.assert_array_equal(got[b].numpy(), want)
        np.testing.assert_array_equal(
            got[b, :n].numpy(), pm_code_lengths(freqs[b, :n])
        )


def test_selector_mtf_and_table_delta_bits_match_jax():
    rng = np.random.default_rng(3)
    sel = rng.integers(0, 6, (3, 400))
    used = np.array([400, 123, 1])
    idx, bits = huffman.selector_mtf(torch.from_numpy(sel),
                                     torch.from_numpy(used))
    tables = rng.integers(1, 18, (3, 6, S))
    ns = np.array([258, 40, 3])
    dbits = huffman.table_delta_bits(torch.from_numpy(tables),
                                     torch.from_numpy(ns))
    for b in range(3):
        ij, bj = jhuf.selector_mtf(jnp.asarray(sel[b], jnp.int32),
                                   jnp.int32(used[b]))
        np.testing.assert_array_equal(idx[b].numpy(), np.asarray(ij))
        assert int(bits[b]) == int(bj)
        assert int(dbits[b]) == int(jhuf.table_delta_bits(
            jnp.asarray(tables[b], jnp.int32), jnp.int32(ns[b])))


def test_banzai_split_matches_jax():
    cases = [(5, 12, 900), (6, 250, M), (7, 199, 3333)]
    syms = np.stack([_stream(s, n, o) for s, n, o in cases])
    out_len = np.array([o for *_, o in cases], np.int32)
    ns = np.array([n for _, n, _ in cases], np.int32)
    hist = huffman.segment_hist(torch.from_numpy(syms),
                                torch.from_numpy(out_len), NSEG)
    freqs = hist.sum(dim=1).to(torch.int64)
    got = banzai_plan.banzai_split(hist, freqs, torch.from_numpy(out_len),
                                   torch.from_numpy(ns))
    for b in range(3):
        hj = jhuf.segment_hist(jnp.asarray(syms[b]), jnp.int32(out_len[b]),
                               NSEG)
        np.testing.assert_array_equal(hist[b].numpy(), np.asarray(hj))
        want = jbp.banzai_split_device(
            hj, jnp.sum(hj, axis=0).astype(jnp.int32), jnp.int32(out_len[b]),
            jnp.int32(ns[b]),
        )
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(want))


def test_exact_float32_matmul_is_set():
    huffman.exact_float32_matmul()
    assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"
