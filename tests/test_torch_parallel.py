"""banzai_tpu_torch's parallel layer on the CPU, held against the JAX
package's (``banzai_tpu.parallel``, ``banzai_tpu.profiling``) and the host
encoder, at level 1 with a few blocks: the serialized payloads, the span
plan, the single-process multihost path, several device threads in one
scheduler, device resolution and the encode report."""

import bz2
import random
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import banzai_tpu_torch
from banzai_tpu.encoder_host import compress as host_compress
from banzai_tpu.parallel import multihost as jax_multihost
from banzai_tpu.parallel.serial import BlockPayload as JaxPayload
from banzai_tpu.profiling import encode_report as jax_encode_report
from banzai_tpu_torch import _build, pipeline, profiling
from banzai_tpu_torch.parallel import _worker, multihost
from banzai_tpu_torch.parallel.dp import block_devices
from banzai_tpu_torch.parallel.serial import BlockPayload
from banzai_tpu_torch.pipeline import EncodeStats

ROOT = Path(__file__).resolve().parents[1]
TEXT = (ROOT / "banzai_tpu" / "ops" / "huffman.py").read_bytes()


def _random(seed: int, n: int) -> bytes:
    return random.Random(seed).randbytes(n)


def _mixed() -> bytes:
    """3 level-1 blocks: random bytes, text and a period-5 run."""
    return _random(1, 160_000) + TEXT[:90_000] + b"abcde" * 24_000


def _pipeline_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith("banzai_tpu_torch-")]


# ---- serialized payloads ----------------------------------------------------

def _payload_fields(rng):
    nbits = int(rng.integers(1, 3000))
    return dict(
        crc=int(rng.integers(0, 2**32)),
        ptr=int(rng.integers(0, 2**24)),
        present=rng.random(256) < 0.5,
        words=rng.integers(0, 2**32, (nbits + 31) // 32 + 3).astype(np.uint32),
        nbits=nbits,
    )


def _same(a, b) -> bool:
    k = (a.nbits + 31) // 32
    return (a.crc == b.crc and a.ptr == b.ptr and a.nbits == b.nbits
            and np.array_equal(a.present, b.present)
            and np.array_equal(a.words[:k], b.words[:k]))


def test_payload_bytes_equal_jax_and_parse_both_ways():
    rng = np.random.default_rng(0)
    fields = [_payload_fields(rng) for _ in range(5)]
    ours = [BlockPayload(**f) for f in fields]
    theirs = [JaxPayload(**f) for f in fields]
    for a, b in zip(ours, theirs):
        assert a.to_bytes() == b.to_bytes()
    blob = b"".join(p.to_bytes() for p in ours)
    jax_blob = b"".join(p.to_bytes() for p in theirs)
    assert blob == jax_blob
    for parsed in (list(JaxPayload.iter_from_bytes(blob)),
                   list(BlockPayload.iter_from_bytes(jax_blob))):
        assert len(parsed) == len(ours)
        assert all(_same(a, b) for a, b in zip(ours, parsed))


def test_pipeline_payloads_stitch_with_jax():
    """The port's payloads of a real encode, serialized and stitched by
    the JAX package's ``_stitch``, give the host encoder's stream."""
    data = _mixed()
    payloads = pipeline.compress_blocks_payloads(data, 1, "cpu")
    blob = b"".join(p.to_bytes() for p in payloads)
    want = host_compress(data, 1, jobs=1)
    assert jax_multihost._stitch([blob], 1) == want
    assert multihost._stitch([blob], 1) == want


# ---- spans ------------------------------------------------------------------

@pytest.mark.parametrize("n_hosts", [1, 2, 3, 5])
def test_plan_spans_equal_jax(n_hosts):
    data = _random(0, 500_000)
    spans = multihost.plan_spans(data, 1, n_hosts)
    want = jax_multihost.plan_spans(data, 1, n_hosts)
    assert [(s.offset, s.length) for s in spans] == [
        (s.offset, s.length) for s in want]
    assert spans[0].offset == 0 and sum(s.length for s in spans) == len(data)


@pytest.mark.parametrize("entry", ["bytes", "path"])
def test_encode_multihost_without_a_group_is_compress(tmp_path, entry):
    data = _random(1, 150_000)
    assert multihost.world() == (1, 0)
    if entry == "bytes":
        out = multihost.encode_multihost(data, 1, device="cpu")
    else:
        src = tmp_path / "in.bin"
        src.write_bytes(data)
        out = multihost.encode_multihost_path(str(src), 1, device="cpu")
    assert out == banzai_tpu_torch.compress(data, 1, "cpu")
    assert bz2.decompress(out) == data


def test_spanwise_encode_matches_host():
    """Spans encoded apart and stitched in order give the host encoder's
    stream (the multi-process composition invariant)."""
    data = _random(2, 260_000)
    blobs = [
        b"".join(p.to_bytes() for p in pipeline.compress_blocks_payloads(
            data[s.offset : s.offset + s.length], 1, "cpu"))
        for s in multihost.plan_spans(data, 1, 2)
    ]
    assert multihost._stitch(blobs, 1) == host_compress(data, 1, jobs=1)


# ---- several device threads -------------------------------------------------

@pytest.mark.parametrize("case", ["two", "three_batch1", "hybrid", "empty",
                                  "tiny"])
def test_device_threads_match_host(case):
    data, devices, kw = _mixed(), ["cpu", "cpu"], {}
    if case == "three_batch1":
        devices, kw = ["cpu"] * 3, {"batch": 1}
    elif case == "hybrid":
        kw = {"hybrid_jobs": 2}
    elif case == "empty":
        data = b""
    elif case == "tiny":
        data = b"abc" * 10
    stats = EncodeStats()
    out = banzai_tpu_torch.compress(data, 1, devices, stats, **kw)
    assert out == banzai_tpu_torch.compress(data, 1, "cpu", **kw)
    assert out == host_compress(data, 1, jobs=1)
    assert bz2.decompress(out) == data
    assert len(stats.device_batches) == len(devices)
    assert sum(stats.device_batches) == stats.batches
    if case == "three_batch1":
        assert stats.batches == stats.device_blocks == 3
    assert _pipeline_threads() == []


def test_device_threads_share_stage_times():
    data = _mixed()
    stats = EncodeStats(stage_ms={})
    out = banzai_tpu_torch.compress(data, 1, ["cpu"] * 3, stats, batch=1)
    assert out == host_compress(data, 1, jobs=1)
    assert {"upload", "bwt", "mtf", "rle2", "plan", "entries", "pack",
            "fetch"} <= set(stats.stage_ms)
    assert all(v >= 0 for v in stats.stage_ms.values())


def test_failed_second_device_thread_raises_and_joins(monkeypatch):
    """Thread device1 fails its first batch while device0 holds its own,
    so the failure is device1's whatever the scheduling."""
    body = pipeline.encode_batch_rows
    failed = threading.Event()

    def spy(rows, **kw):
        if threading.current_thread().name.endswith("device1"):
            failed.set()
            raise RuntimeError("device batch failed on device1")
        assert failed.wait(timeout=60)
        return body(rows, **kw)

    monkeypatch.setattr(pipeline, "encode_batch_rows", spy)
    with pytest.raises(RuntimeError, match="failed on device1"):
        banzai_tpu_torch.compress(_mixed(), 1, ["cpu", "cpu"], batch=1)
    assert _pipeline_threads() == []


def test_launch_count_under_threads():
    """``_build.count_launch`` from more threads than cores, with a short
    switch interval, loses no update."""
    _build.LAUNCHES.pop("stress", None)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [_build.count_launch("stress")
                            for _ in range(5000)])
            for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert _build.LAUNCHES.pop("stress") == 16 * 5000


# ---- device resolution ------------------------------------------------------

def _fake_cards(monkeypatch, n: int) -> None:
    monkeypatch.setattr(torch.cuda, "is_available", lambda: n > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)


def test_block_devices_resolution(monkeypatch):
    cpu, c = torch.device("cpu"), lambda i: torch.device("cuda", i)
    assert block_devices("cpu") == [cpu]
    assert block_devices(["cpu", "cpu"]) == [cpu, cpu]
    assert block_devices((cpu,)) == [cpu]
    with pytest.raises(ValueError, match="no device"):
        block_devices([])
    _fake_cards(monkeypatch, 2)
    # Several cards are opt-in: "cuda" stays the current card.
    assert block_devices("cuda") == [c(0)]
    assert block_devices(torch.device("cuda")) == [c(0)]
    assert block_devices("cuda:1") == [c(1)]
    assert block_devices(["cuda:0", "cuda:1"]) == [c(0), c(1)]
    assert block_devices(["cuda:0", "cuda:0"]) == [c(0), c(0)]
    with pytest.raises(ValueError, match="more than one type"):
        block_devices(["cpu", "cuda:0"])
    _fake_cards(monkeypatch, 1)
    assert block_devices("cuda") == [c(0)]


def test_block_devices_past_the_visible_cards_raise(monkeypatch):
    _fake_cards(monkeypatch, 2)
    with pytest.raises(RuntimeError, match="only 2 CUDA devices"):
        block_devices(["cuda:0", "cuda:2"])
    with pytest.raises(RuntimeError, match="only 2 CUDA devices"):
        block_devices("cuda:7")


@pytest.mark.parametrize("cards, rank, want", [
    (1, 0, "cuda:0"), (1, 1, "cuda:0"), (4, 2, "cuda:2"), (4, 5, "cuda:1"),
    (0, 0, "cuda"),
])
def test_worker_default_device_is_one_card_per_rank(monkeypatch, cards,
                                                     rank, want):
    _fake_cards(monkeypatch, cards)
    assert _worker.default_device(rank) == want
    if cards == 0:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            block_devices(_worker.default_device(rank))


_ENTRIES = {
    "block_devices": lambda p: block_devices("cuda"),
    "compress": lambda p: banzai_tpu_torch.compress(b"x" * 100, 1, "cuda"),
    "compress_list": lambda p: banzai_tpu_torch.compress(
        b"x" * 100, 1, ["cuda:0", "cuda:0"]),
    "encode_file": lambda p: banzai_tpu_torch.encode_file(p, p + ".bz2", 1),
    "encode_multihost": lambda p: multihost.encode_multihost(b"x" * 100, 1),
    "encode_multihost_path": lambda p: multihost.encode_multihost_path(p, 1),
    "encode_report": lambda p: profiling.encode_report(
        b"x" * 100, 1, backend="device"),
}


@pytest.mark.parametrize("entry", list(_ENTRIES))
def test_cuda_without_a_card_raises(monkeypatch, tmp_path, entry):
    _fake_cards(monkeypatch, 0)
    src = tmp_path / "in.bin"
    src.write_bytes(b"x" * 100)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _ENTRIES[entry](str(src))
    assert _pipeline_threads() == []


# ---- the encode report --------------------------------------------------------

def _rows(report):
    return [(b.index, b.consumed, b.rle1_len, b.payload_bits, b.ptr, b.crc)
            for b in report.blocks]


def test_encode_report_equals_jax():
    data = _mixed()
    want = jax_encode_report(data, 1)
    got = profiling.encode_report(data, 1)
    assert len(got.blocks) == 3
    assert _rows(got) == _rows(want)
    assert _rows(profiling.encode_report(data, 1, "device", "cpu")) == \
        _rows(want)
    assert set(got.stage_seconds) == set(want.stage_seconds)
    assert got.summary().splitlines()[0] == want.summary().splitlines()[0]
    with pytest.raises(ValueError, match="backend"):
        profiling.encode_report(data, 1, backend="jax")


def test_stage_timer_adds_up():
    report = profiling.EncodeReport(level=1)
    for _ in range(2):
        with profiling.stage_timer(report, "step"):
            pass
    assert list(report.stage_seconds) == ["step"]
    assert report.stage_seconds["step"] >= 0
