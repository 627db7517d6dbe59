"""banzai_tpu_torch's K2 (MTF indices to RLE2 symbols) and K3 (payload
entries to words) wrappers on CPU tensors, which run their plain versions,
vs the JAX package's ``rle2_expand_batch`` and ``pack_words_batch``, whose
Pallas kernels run in interpret mode on the CPU; and the entry passes
inside them (``rle2_entries``, ``splice_entries``) field by field.  Exact
equality everywhere.

The carry cases are the ones the card's tiled kernels (2048 lanes or
entries a tile) find hard: zero runs across several tiles, rows ending
inside a tile, lengths of 32, a word capacity below the payload."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from banzai_tpu.ops.bitpack import pack_entries as jax_pack_entries
from banzai_tpu.ops.bitpack import splice_entries as jax_splice
from banzai_tpu.ops.rle2 import rle2_entries as jax_rle2_entries
from banzai_tpu.ops.stream_pallas import pack_words_batch as jax_pack_batch
from banzai_tpu.ops.stream_pallas import rle2_expand_batch as jax_rle2_batch
from banzai_tpu_torch import _build
from banzai_tpu_torch.ops.bitpack import splice_entries
from banzai_tpu_torch.ops.rle2 import rle2_entries
from banzai_tpu_torch.ops.stream_kernels import (
    PACK_TILE, RLE2_TILE, pack_words_batch, rle2_expand_batch,
)

N = 4096


def _mtf_case(rng, n, kind):
    if kind == "mixed":
        raw = np.where(rng.random(n) < 0.6, 0, rng.integers(1, 200, n))
    elif kind == "zeros":
        raw = np.zeros(n, np.int64)              # one huge run: 12 digits
    elif kind == "runs":
        parts, total = [], 0
        while total < n:
            parts += [np.zeros(rng.integers(1, 300)),
                      np.array([rng.integers(1, 255)])]
            total += len(parts[-2]) + 1
        raw = np.concatenate(parts)[:n]
    else:
        raw = rng.integers(0, 255, n)
    return raw.astype(np.int32)


def _rle2_inputs(kind):
    rng = np.random.default_rng(sum(kind.encode()))
    idx = np.stack([_mtf_case(rng, N, kind) for _ in range(2)])
    ns = np.array([N, N - 100], np.int32)
    names = np.array([254, 31], np.int32)
    return idx, ns, names


def _rle2_both(idx, ns, names):
    """The port's rle2_expand_batch on CPU tensors against the JAX
    function in interpret mode; returns the port's (syms, out_len)."""
    syms, out_len = rle2_expand_batch(torch.from_numpy(idx),
                                      torch.from_numpy(ns),
                                      torch.from_numpy(names))
    syms_k, len_k = jax_rle2_batch(jnp.asarray(idx), jnp.asarray(ns),
                                   jnp.asarray(names), interpret=True)
    assert syms.dtype == out_len.dtype == torch.int32
    assert syms.shape == (idx.shape[0], idx.shape[1] + 1)
    np.testing.assert_array_equal(syms.numpy(), np.asarray(syms_k))
    np.testing.assert_array_equal(out_len.numpy(), np.asarray(len_k))
    return syms, out_len


@pytest.mark.parametrize("kind", ["mixed", "zeros", "runs", "dense"])
def test_rle2_entries_and_expand_match_pallas(kind):
    idx, ns, names = _rle2_inputs(kind)
    ent = rle2_entries(torch.from_numpy(idx), torch.from_numpy(ns),
                       torch.from_numpy(names))
    want = jax.vmap(jax_rle2_entries)(
        jnp.asarray(idx), jnp.asarray(ns), jnp.asarray(names)
    )
    for got_f, want_f in zip(ent, want):
        np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))
    _, out_len = _rle2_both(idx, ns, names)
    np.testing.assert_array_equal(out_len.numpy(), ent[4].numpy())


def test_rle2_expand_tiny_n():
    # n far below one tile, and n == 1 (EOB right after one symbol).
    rng = np.random.default_rng(7)
    idx = rng.integers(0, 5, (2, 512)).astype(np.int32)
    _rle2_both(idx, np.array([3, 1], np.int32), np.array([5, 2], np.int32))


def _carry_case(kind):
    rng = np.random.default_rng(len(kind))
    T = RLE2_TILE
    if kind == "zero_run_over_3_tiles":
        n = 5 * T + 300
        idx = np.stack([_mtf_case(rng, n, "mixed") for _ in range(2)])
        idx[0, 100 : 100 + 3 * T + 777] = 0          # crosses 4 tiles
        idx[1, T - 5 :] = 0                          # runs into the EOB
        ns = [n, n - 3]
    elif kind == "n_inside_tile":
        n = 3 * T
        idx = np.stack([_mtf_case(rng, n, "runs") for _ in range(3)])
        ns = [T + 1, 2 * T - 1, 2 * T + 700]
    elif kind == "batch_of_one":
        n = 2 * T + 1
        idx = _mtf_case(rng, n, "mixed")[None]
        ns = [n]
    else:                                            # "minus_one_past_n"
        n = 2 * T + 17
        idx = np.stack([_mtf_case(rng, n, "dense") for _ in range(2)])
        ns = [T + 9, 7]
    ns = np.array(ns, np.int32)
    # Lanes past n hold -1, as ``mtf_indices`` leaves them.
    idx = np.where(np.arange(idx.shape[1])[None, :] < ns[:, None], idx, -1)
    names = np.array([255, 40, 3][: len(ns)], np.int32)
    return idx.astype(np.int32), ns, names


@pytest.mark.parametrize("kind", ["zero_run_over_3_tiles", "n_inside_tile",
                                  "batch_of_one", "minus_one_past_n"])
def test_rle2_expand_batch_carry_cases(kind):
    idx, ns, names = _carry_case(kind)
    syms, out_len = _rle2_both(idx, ns, names)
    for b in range(len(ns)):
        assert (syms[b, int(out_len[b]):] == 258).all()


def _entry_case(rng, E, kind):
    if kind == "wide":
        lens = rng.integers(20, 33, E)
    elif kind == "sparse":
        lens = np.where(rng.random(E) < 0.8, 0, rng.integers(1, 18, E))
    elif kind == "len32":
        lens = np.where(rng.random(E) < 0.5, 32, rng.integers(0, 33, E))
    else:
        lens = rng.integers(0, 18, E)
    vals = rng.integers(0, 1 << 32, E, dtype=np.uint64)
    return vals.astype(np.uint32), lens.astype(np.int32)


def _pack_both(vals, lens, nwords):
    """The port's pack_words_batch on int64 CPU rows against the JAX
    function in interpret mode; returns the port's (words, total)."""
    words, total = pack_words_batch(
        torch.from_numpy(vals.astype(np.int64)),
        torch.from_numpy(lens.astype(np.int64)), nwords)
    words_k, tot_k = jax_pack_batch(
        jnp.asarray(vals), jnp.asarray(lens), nwords, interpret=True
    )
    assert words.dtype == total.dtype == torch.int32
    assert words.shape == (vals.shape[0], nwords)
    np.testing.assert_array_equal(total.numpy(), np.asarray(tot_k))
    np.testing.assert_array_equal(words.numpy().view(np.uint32),
                                  np.asarray(words_k))
    return words, total


@pytest.mark.parametrize("kind", ["mixed", "wide", "sparse"])
def test_pack_matches_pallas(kind):
    rng = np.random.default_rng(sum(kind.encode()))
    cases = [_entry_case(rng, 4 * 256 - 9, kind) for _ in range(2)]
    vals = np.stack([c[0] for c in cases])
    lens = np.stack([c[1] for c in cases])
    nwords = int(lens.sum(1).max()) // 32 + 3
    _pack_both(vals, lens, nwords)
    # splice_entries field by field, per block.
    w, hi2, total = splice_entries(torch.from_numpy(vals.astype(np.int64)),
                                   torch.from_numpy(lens))
    for b in range(2):
        wj, hj, tj = jax_splice(jnp.asarray(vals[b]), jnp.asarray(lens[b]))
        np.testing.assert_array_equal(w[b].numpy(), np.asarray(wj))
        np.testing.assert_array_equal(hi2[b].numpy(), np.asarray(hj))
        assert int(total[b]) == int(tj)


def test_pack_single_word_pileup():
    # Hundreds of zero-length entries sharing one word.
    E = 3 * 256
    lens = np.zeros(E, np.int32)
    lens[0], lens[-1] = 7, 13
    vals = np.full(E, 0x5A, np.uint32)
    words, total = _pack_both(vals[None], lens[None], 4)
    assert int(total[0]) == 20
    w_x, t_x = jax_pack_entries(jnp.asarray(vals), jnp.asarray(lens), 4)
    np.testing.assert_array_equal(words[0].numpy().view(np.uint32),
                                  np.asarray(w_x))


def test_pack_drops_entries_past_nwords():
    rng = np.random.default_rng(11)
    vals, lens = _entry_case(rng, 500, "wide")
    nwords = int(lens.sum()) // 64          # capacity below the payload
    _, total = _pack_both(vals[None], lens[None], nwords)
    assert int(total[0]) == int(lens.sum()) > nwords * 32


@pytest.mark.parametrize("kind", ["len32_across_tiles", "over_capacity",
                                  "batch_of_one", "tile_sized"])
def test_pack_words_batch_carry_cases(kind):
    rng = np.random.default_rng(len(kind) + 100)
    P = PACK_TILE
    B, E = {"batch_of_one": (1, 2 * P + 1), "tile_sized": (2, P)}.get(
        kind, (2, 2 * P + 33))
    cases = [_entry_case(rng, E, "len32" if kind != "tile_sized" else
                         "mixed") for _ in range(B)]
    vals = np.stack([c[0] for c in cases])
    lens = np.stack([c[1] for c in cases])
    want_total = lens.astype(np.int64).sum(1)
    nwords = int(want_total.max()) // 32 + 2
    if kind == "over_capacity":
        nwords = int(want_total.min()) // 96
    _, total = _pack_both(vals, lens, nwords)
    np.testing.assert_array_equal(total.numpy(), want_total)


def test_cpu_tensors_take_plain_versions():
    idx, ns, names = _rle2_inputs("mixed")
    before = dict(_build.LAUNCHES)
    rle2_expand_batch(torch.from_numpy(idx), torch.from_numpy(ns),
                      torch.from_numpy(names))
    pack_words_batch(torch.ones((1, 40), dtype=torch.int64),
                     torch.full((1, 40), 9, dtype=torch.int64), 16)
    assert dict(_build.LAUNCHES) == before


def test_wrappers_reject_wrong_dtype():
    idx, ns, names = _rle2_inputs("mixed")
    t_idx, t_ns, t_names = map(torch.from_numpy, (idx, ns, names))
    with pytest.raises(ValueError):
        rle2_expand_batch(t_idx.to(torch.int64), t_ns, t_names)
    with pytest.raises(ValueError):
        rle2_expand_batch(t_idx, t_ns[:1], t_names)
    with pytest.raises(ValueError):
        pack_words_batch(torch.zeros((1, 4), dtype=torch.int32),
                         torch.zeros((1, 4), dtype=torch.int64), 2)
    # Neither CPU nor CUDA: raise, never fall back to the plain version.
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        rle2_expand_batch(t_idx.to(meta), t_ns.to(meta), t_names.to(meta))
    with pytest.raises(ValueError, match="unsupported device"):
        pack_words_batch(torch.zeros((1, 4), dtype=torch.int64, device=meta),
                         torch.zeros((1, 4), dtype=torch.int64, device=meta),
                         2)
