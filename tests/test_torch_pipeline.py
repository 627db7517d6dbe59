"""banzai_tpu_torch end to end on the CPU: the batch body vs the JAX
package's, and whole streams vs the host encoder and the bz2 decoder."""

import bz2
import os
import random
import subprocess
import sys
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import banzai_tpu_torch
from banzai_tpu.encoder_host import TINY_BLOCK, compress as host_compress
from banzai_tpu.parallel import dp
from banzai_tpu.pipeline import _nwords as jax_nwords
from banzai_tpu_torch._device import resolve_device
from banzai_tpu_torch.block import encode_batch_rows
from banzai_tpu_torch.pipeline import (
    EncodeStats, _CHUNK, _nwords, compress_blocks_payloads, stage_rows,
)

ROOT = Path(__file__).resolve().parents[1]
CORPUS = sorted((ROOT / "tests" / "corpus").glob("*.bin"))


def test_encode_batch_rows_matches_jax():
    N = 8192
    nseg = (N + 1 + 49) // 50
    nwords = _nwords(N, nseg)
    assert nwords == jax_nwords(N, nseg)
    text = (ROOT / "banzai_tpu" / "ops" / "huffman.py").read_bytes()[:8000]
    outputs = [
        np.frombuffer(text, np.uint8),
        np.frombuffer(b"abcde" * 1000, np.uint8),
    ]
    rows, _ = stage_rows(outputs, N, 2)
    assert rows.shape == (2, N + 260) and rows.dtype == torch.uint8
    got = encode_batch_rows(rows, nseg=nseg, nwords=nwords, chunk=_CHUNK)
    f = jax.jit(partial(dp.encode_batch_rows, nseg=nseg, nwords=nwords,
                        chunk=_CHUNK, use_pallas=False))
    want = f(jnp.asarray(rows.numpy()))
    names = ("words", "nbits", "ptr", "plan_bits", "split", "out_len")
    for name, g, w in zip(names, got, want):
        g = g.numpy()
        if name == "words":
            g = g.view(np.uint32)
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)


def _mixed(seed: int, size: int) -> bytes:
    rng = random.Random(seed)
    text = (ROOT / "banzai_tpu" / "ops" / "bwt.py").read_bytes()
    dna = bytes(rng.choice(b"ACGT") for _ in range(size // 4))
    parts = [text * 3, rng.randbytes(size // 3), b"\x00" * 40_000,
             b"abcde" * 8_000, dna]
    return b"".join(parts)


@pytest.mark.parametrize("seed", [0, 1])
def test_compress_level1_matches_host_and_decodes(seed):
    data = _mixed(seed, 240_000)
    stats = EncodeStats()
    out = banzai_tpu_torch.compress(data, 1, device="cpu", stats=stats)
    assert out == host_compress(data, 1, jobs=1)
    assert bz2.decompress(out) == data
    assert stats.device_blocks >= 3
    assert stats.host_capacity == 0


def test_compress_routes_tiny_tail_to_host():
    data = random.Random(9).randbytes(100_000 + 5_000)
    stats = EncodeStats(stage_ms={})
    payloads = compress_blocks_payloads(data, 1, "cpu", stats=stats)
    assert len(payloads) == 2
    assert (stats.device_blocks, stats.host_tiny) == (1, 1)
    assert {"bwt", "mtf", "rle2", "plan", "entries", "pack"} <= set(
        stats.stage_ms
    )
    assert len(payloads[1].words) * 32 >= payloads[1].nbits
    assert 5_000 <= TINY_BLOCK


@pytest.mark.parametrize("path", CORPUS, ids=[p.name for p in CORPUS])
def test_compress_corpus_matches_host(path):
    data = path.read_bytes()
    out = banzai_tpu_torch.compress(data, 9, device="cpu")
    assert out == host_compress(data, 9, jobs=1)
    assert bz2.decompress(out) == data


def test_compress_empty_input():
    out = banzai_tpu_torch.compress(b"", 9, device="cpu")
    assert out == host_compress(b"", 9, jobs=1)
    assert bz2.decompress(out) == b""


def test_port_never_imports_jax():
    code = (
        "import sys, banzai_tpu_torch\n"
        "out = banzai_tpu_torch.compress(bytes(range(256)) * 100, 1, "
        "device='cpu')\n"
        "import bz2; assert bz2.decompress(out) == bytes(range(256)) * 100\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        banzai_tpu_torch.compress(b"x" * 100, 9, device="cuda")
    with pytest.raises(ValueError):
        resolve_device("meta")
    with pytest.raises(ValueError):
        banzai_tpu_torch.compress(b"x", 10, device="cpu")
