"""banzai_tpu_torch RLE2 entries, expansion (K2's plain version) and word
assembly (K3's plain version) vs the JAX package, whose Pallas kernels run
in interpret mode on the CPU.  Exact equality everywhere."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from banzai_tpu.ops.bitpack import pack_entries as jax_pack_entries
from banzai_tpu.ops.bitpack import splice_entries as jax_splice
from banzai_tpu.ops.rle2 import rle2_entries as jax_rle2_entries
from banzai_tpu.ops.stream_pallas import pack_words_batch, rle2_expand_batch
from banzai_tpu_torch import _build
from banzai_tpu_torch.ops.bitpack import pack_entries, splice_entries
from banzai_tpu_torch.ops.rle2 import rle2_entries
from banzai_tpu_torch.ops.stream_kernels import (
    as_int32_bits, pack_words, rle2_expand,
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
    syms = rle2_expand(*ent)
    syms_k, len_k = rle2_expand_batch(
        jnp.asarray(idx), jnp.asarray(ns), jnp.asarray(names), interpret=True
    )
    np.testing.assert_array_equal(syms.numpy(), np.asarray(syms_k))
    np.testing.assert_array_equal(ent[4].numpy(), np.asarray(len_k))


def test_rle2_expand_tiny_n():
    # n far below one tile, and n == 1 (EOB right after one symbol).
    rng = np.random.default_rng(7)
    idx = rng.integers(0, 5, (2, 512)).astype(np.int32)
    ns = np.array([3, 1], np.int32)
    names = np.array([5, 2], np.int32)
    ent = rle2_entries(torch.from_numpy(idx), torch.from_numpy(ns),
                       torch.from_numpy(names))
    syms_k, len_k = rle2_expand_batch(
        jnp.asarray(idx), jnp.asarray(ns), jnp.asarray(names), interpret=True
    )
    np.testing.assert_array_equal(rle2_expand(*ent).numpy(),
                                  np.asarray(syms_k))


def _entry_case(rng, E, kind):
    if kind == "wide":
        lens = rng.integers(20, 33, E)
    elif kind == "sparse":
        lens = np.where(rng.random(E) < 0.8, 0, rng.integers(1, 18, E))
    else:
        lens = rng.integers(0, 18, E)
    vals = rng.integers(0, 1 << 32, E, dtype=np.uint64)
    return vals.astype(np.uint32), lens.astype(np.int32)


def _pack_both(vals, lens, nwords):
    words, total = pack_entries(torch.from_numpy(vals.astype(np.int64)),
                                torch.from_numpy(lens), nwords)
    words_k, tot_k = pack_words_batch(
        jnp.asarray(vals), jnp.asarray(lens), nwords, interpret=True
    )
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
    _pack_both(vals[None], lens[None], nwords)


def test_cpu_tensors_take_plain_versions():
    idx, ns, names = _rle2_inputs("mixed")
    ent = rle2_entries(torch.from_numpy(idx), torch.from_numpy(ns),
                       torch.from_numpy(names))
    w, hi2, total = splice_entries(
        torch.ones((1, 40), dtype=torch.int64),
        torch.full((1, 40), 9, dtype=torch.int64),
    )
    before = dict(_build.LAUNCHES)
    rle2_expand(*ent)
    pack_words(w.to(torch.int32), as_int32_bits(hi2), total.to(torch.int32), 16)
    assert dict(_build.LAUNCHES) == before


def test_wrappers_reject_wrong_dtype():
    idx, ns, names = _rle2_inputs("mixed")
    ent = rle2_entries(torch.from_numpy(idx), torch.from_numpy(ns),
                       torch.from_numpy(names))
    with pytest.raises(ValueError):
        rle2_expand(ent[0].to(torch.int64), *ent[1:])
    with pytest.raises(ValueError):
        pack_words(torch.zeros((1, 4), dtype=torch.int64),
                   torch.zeros((1, 4), dtype=torch.int32),
                   torch.zeros(1, dtype=torch.int32), 2)
