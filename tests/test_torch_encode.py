"""banzai_tpu_torch's streaming path on the CPU: ``encode`` and the
overlapped block scheduler (``pipeline.compress_blocks_iter``) against
the JAX package's ``encode`` and the host encoder, at level 1."""

import bz2
import io
import random
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import banzai_tpu
import banzai_tpu_torch
from banzai_tpu.encoder_host import TINY_BLOCK, compress as host_compress
from banzai_tpu.pipeline import _hardness as jax_hardness
from banzai_tpu.rle1 import iter_blocks
from banzai_tpu_torch import pipeline
from banzai_tpu_torch.block import ROW_EXTRA
from banzai_tpu_torch.pipeline import EncodeStats, compress_blocks_iter

ROOT = Path(__file__).resolve().parents[1]
TEXT = (ROOT / "banzai_tpu" / "ops" / "bwt.py").read_bytes()


def _text(n: int) -> bytes:
    return (TEXT * (n // len(TEXT) + 1))[:n]


def _random(seed: int, n: int) -> bytes:
    return random.Random(seed).randbytes(n)


def _pipeline_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith("banzai_tpu_torch-")]


def test_encode_spans_match_jax_encode_and_host():
    data = _random(3, 200_000) + _text(90_000) + b"abcde" * 12_000
    r, w = io.BytesIO(data), io.BytesIO()
    n = banzai_tpu_torch.encode(r, w, 1, device="cpu", span_bytes=120_000)
    out = w.getvalue()
    assert n == len(out)
    want = io.BytesIO()
    banzai_tpu.encode(io.BytesIO(data), want, 1, backend="numpy",
                      span_bytes=120_000)
    assert out == want.getvalue() == host_compress(data, 1, jobs=1)
    assert bz2.decompress(out) == data


def test_encode_empty_input():
    w = io.BytesIO()
    n = banzai_tpu_torch.encode(io.BytesIO(b""), w, 1, device="cpu")
    want = io.BytesIO()
    banzai_tpu.encode(io.BytesIO(b""), want, 1, backend="numpy")
    assert n == len(w.getvalue()) == 14
    assert w.getvalue() == want.getvalue()


def test_encode_file_and_report(tmp_path):
    from banzai_tpu.profiling import EncodeReport

    data = _text(150_000)
    src, dst = tmp_path / "in.txt", tmp_path / "in.txt.bz2"
    src.write_bytes(data)
    banzai_tpu_torch.encode_file(str(src), str(dst), 1, device="cpu")
    assert dst.read_bytes() == host_compress(data, 1, jobs=1)
    rep = EncodeReport(level=1)
    banzai_tpu_torch.encode(io.BytesIO(data), io.BytesIO(), 1, "cpu",
                            report=rep)
    assert sum(b.consumed for b in rep.blocks) == len(data)
    assert len(rep.blocks) == 2 and all(b.payload_bits > 0 for b in rep.blocks)


def test_hardness_matches_jax():
    data = (_text(120_000) + _random(1, 110_000) + b"xyz" * 40_000
            + bytes(range(256)) * 300 + b"q" * 5_000)
    outs = [blk.output for blk in iter_blocks(data, 1)]
    assert len(outs) >= 4
    # Short outputs take the unsampled branch (<= 16384 bytes).
    outs += [o[:n] for o, n in zip(outs, (100, 16384, 16385))]
    for out in outs:
        assert pipeline._hardness(out) == jax_hardness(out)


def _row_key(rows: torch.Tensor, i: int) -> bytes:
    N = rows.shape[1] - ROW_EXTRA
    nb = rows[i, N + 256 : N + 259].to(torch.int64)
    n = int(nb[0] | (nb[1] << 8) | (nb[2] << 16))
    return rows[i, :n].numpy().tobytes()


def test_batch1_hardness_window_reorders(monkeypatch):
    data = (_text(200_000) + b"xyz" * 33_400 + _random(4, 100_000)
            + b"mnop" * 25_000 + _random(5, 100_000) + _random(6, 60_000))
    outputs = [b.output.tobytes() for b in iter_blocks(data, 1)]
    assert len(outputs) >= 7
    assert all(len(o) > TINY_BLOCK for o in outputs)
    order = []
    body = pipeline.encode_batch_rows

    def spy(rows, **kw):
        order.extend(outputs.index(_row_key(rows, i))
                     for i in range(rows.shape[0]))
        return body(rows, **kw)

    monkeypatch.setattr(pipeline, "encode_batch_rows", spy)
    stats = EncodeStats()
    out = banzai_tpu_torch.compress(data, 1, "cpu", stats, batch=1)
    # Blocks 0 and 1 go out unsorted; then each window of _SORT_WINDOW
    # blocks runs in the stable order of the JAX package's scores.
    score = [jax_hardness(np.frombuffer(o, np.uint8)) for o in outputs]
    want = [0, 1]
    for w0 in range(2, len(outputs), pipeline._SORT_WINDOW):
        window = range(w0, min(w0 + pipeline._SORT_WINDOW, len(outputs)))
        want += sorted(window, key=score.__getitem__)
    assert order == want and order != sorted(order)
    assert stats.batches == len(outputs) == stats.device_blocks
    assert out == host_compress(data, 1, jobs=1)


def test_hybrid_jobs_identical_stream():
    data = _text(150_000) + _random(7, 220_000)
    stats = EncodeStats()
    out = banzai_tpu_torch.compress(data, 1, "cpu", stats, hybrid_jobs=2)
    assert out == host_compress(data, 1, jobs=1)
    assert stats.host_hybrid >= 1
    assert stats.host_hybrid + stats.device_blocks == 4


def _boom(*args, **kwargs):
    raise RuntimeError("device batch failed")


def _run_compress(data):
    return banzai_tpu_torch.compress(data, 1, "cpu", batch=1)


def _run_encode(data):
    return banzai_tpu_torch.encode(io.BytesIO(data), io.BytesIO(), 1, "cpu",
                                   span_bytes=60_000)


@pytest.mark.parametrize("entry", [_run_compress, _run_encode],
                         ids=["compress", "encode"])
def test_failed_device_batch_raises_and_joins(monkeypatch, entry):
    monkeypatch.setattr(pipeline, "encode_batch_rows", _boom)
    with pytest.raises(RuntimeError, match="device batch failed"):
        entry(_random(8, 250_000))
    assert _pipeline_threads() == []


def test_failed_reader_raises_and_joins():
    class Reader:
        calls = 0

        def read(self, n):
            self.calls += 1
            if self.calls > 2:
                raise OSError("disk gone")
            return _random(self.calls, n)

    with pytest.raises(OSError, match="disk gone"):
        banzai_tpu_torch.encode(Reader(), io.BytesIO(), 1, "cpu",
                                span_bytes=80_000)
    assert _pipeline_threads() == []


def test_early_close_joins_threads():
    data = _random(9, 400_000)
    it = compress_blocks_iter(iter_blocks(data, 1), 1, "cpu", batch=1)
    blk, payload = next(it)
    assert blk.consumed > 0 and payload.nbits > 0
    assert _pipeline_threads()
    it.close()
    assert _pipeline_threads() == []


def test_forced_bucket_miss_refetches(monkeypatch):
    data = _text(120_000) + _random(10, 100_000)
    key = (1, pipeline._padded_len(1))
    monkeypatch.setitem(pipeline._K_SEED, key, (1, 1, 1))
    stats = EncodeStats()
    out = banzai_tpu_torch.compress(data, 1, "cpu", stats)
    assert stats.refetches == stats.batches >= 1
    assert out == host_compress(data, 1, jobs=1)
    # The next call starts from this call's window: no miss.
    assert max(pipeline._K_SEED[key]) > 256
    again = EncodeStats()
    assert banzai_tpu_torch.compress(data, 1, "cpu", again) == out
    assert again.refetches == 0


@pytest.mark.parametrize("case", ["one_block", "tiny_only", "capacity"])
def test_edge_streams_match_host(monkeypatch, case):
    """A batch of one block, a stream of one tiny block, and blocks whose
    payload exceeds the word capacity (forced with a small capacity)."""
    if case == "one_block":
        data, level, routes = _random(11, 60_000), 1, {"device_blocks": 1}
    elif case == "tiny_only":
        data, level, routes = b"abc" * 10, 9, {"host_tiny": 1}
    else:
        monkeypatch.setattr(pipeline, "_nwords", lambda N, nseg: 3000)
        data = b"abcd" * 30_000 + _random(12, 120_000)
        level, routes = 1, {"device_blocks": 1, "host_capacity": 2}
    stats = EncodeStats()
    out = banzai_tpu_torch.compress(data, level, "cpu", stats, batch=1)
    assert out == host_compress(data, level, jobs=1)
    assert bz2.decompress(out) == data
    for name in ("device_blocks", "host_tiny", "host_capacity"):
        assert getattr(stats, name) == routes.get(name, 0), name


def test_encode_cuda_without_a_card_writes_nothing(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    w = io.BytesIO()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        banzai_tpu_torch.encode(io.BytesIO(b"x" * 1000), w, 9, "cuda")
    assert w.getvalue() == b""


def test_batch_must_be_positive():
    with pytest.raises(ValueError, match="batch"):
        banzai_tpu_torch.compress(b"x" * 100, 1, "cpu", batch=0)


def test_concurrent_pipelines_under_short_switch_interval():
    """Several pipelines at once in one process (each with its threads),
    with a short switch interval: every stream stays the host's."""
    datas = [_random(20 + i, 110_000) + _text(30_000) for i in range(6)]
    got = [None] * len(datas)

    def run(i):
        got[i] = banzai_tpu_torch.compress(datas[i], 1, "cpu", batch=1)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(datas))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert got == [host_compress(d, 1, jobs=1) for d in datas]
    assert _pipeline_threads() == []
