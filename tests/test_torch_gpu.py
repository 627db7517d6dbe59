"""banzai_tpu_torch's CUDA kernels vs their plain PyTorch versions, on the
card.  Every test here is marked ``gpu`` and skips without a CUDA device.

This file imports no JAX, so it runs on a machine that has none:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q
"""

import bz2
import random

import numpy as np
import pytest
import torch

import banzai_tpu_torch
from banzai_tpu.encoder_host import compress as host_compress
from banzai_tpu_torch import _build
from banzai_tpu_torch.ops.bitpack import splice_entries
from banzai_tpu_torch.ops.mtf_kernel import mtf_shuffle, mtf_shuffle_plain
from banzai_tpu_torch.ops.rle2 import rle2_entries
from banzai_tpu_torch.ops.stream_kernels import (
    as_int32_bits, pack_words, pack_words_plain, rle2_expand,
    rle2_expand_plain,
)
from banzai_tpu_torch.pipeline import EncodeStats

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("C,K", [(1000, 64), (37, 100), (5, 7)])
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


def _mtf_like(rng, B, N):
    raw = np.where(rng.random((B, N)) < 0.6, 0, rng.integers(1, 200, (B, N)))
    raw[0, : N // 2] = 0                                    # one long run
    return raw.astype(np.int32)


@pytest.mark.parametrize("ns", [[20000, 19000, 7], [1, 2, 3]])
def test_rle2_expand_kernel_matches_plain(cuda, ns):
    rng = np.random.default_rng(len(ns) + ns[0])
    idx = torch.from_numpy(_mtf_like(rng, 3, 20000)).to(cuda)
    ent = rle2_entries(idx, torch.tensor(ns, device=cuda),
                       torch.tensor([200, 31, 5], device=cuda))
    got = rle2_expand(*ent)
    torch.testing.assert_close(got, rle2_expand_plain(*ent), rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["mixed", "pileup", "overflow"])
def test_pack_words_kernel_matches_plain(cuda, kind):
    rng = np.random.default_rng(len(kind))
    E = 5000
    if kind == "pileup":
        lens = np.zeros((2, E), np.int64)
        lens[:, 0], lens[:, -1] = 7, 13
    else:
        lens = rng.integers(0, 33 if kind == "overflow" else 18, (2, E))
    vals = rng.integers(0, 1 << 32, (2, E), dtype=np.int64)
    w, hi2, total = splice_entries(torch.from_numpy(vals).to(cuda),
                                   torch.from_numpy(lens).to(cuda))
    nwords = int(total.max()) // (64 if kind == "overflow" else 32) + 2
    args = (torch.clamp(w, max=nwords).to(torch.int32).contiguous(),
            as_int32_bits(hi2).contiguous(), total.to(torch.int32), nwords)
    torch.testing.assert_close(pack_words(*args), pack_words_plain(*args),
                               rtol=0, atol=0)


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
