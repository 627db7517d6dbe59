"""The scheduler's spans on the CPU: wall and thread CPU time per span in
``EncodeStats``, the profiler ranges they open while a ``torch.profiler``
records (and only then), and ``stats=`` on ``encode``."""

import io
import json
import random
import sys
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import banzai_tpu_torch
from banzai_tpu_torch import spans
from banzai_tpu_torch.pipeline import EncodeStats

ROUTES = ("device_blocks", "host_tiny", "host_capacity", "host_banzai",
          "host_hybrid")
QUEUE_WAITS = ("device_wait_staged", "device_wait_fetched",
               "producer_wait_staged", "drain_wait_fetched", "caller_wait")


def _data(seed: int = 5) -> bytes:
    """Four level-1 blocks of mixed content and a tiny tail block."""
    rng = random.Random(seed)
    words = [b"alpha ", b"beta ", b"gamma\n", b"delta, ", b"0123 "]
    text = b"".join(rng.choice(words) for _ in range(30_000))
    return (text[:150_000] + rng.randbytes(120_000) + b"xyz" * 40_000
            + rng.randbytes(10_000))


def _cpu_step_ms() -> float:
    """The step of the thread CPU clock: the smallest rise seen in a busy
    loop (one read rises by the clock's resolution, or by a tick on a
    host whose clock ticks)."""
    rises = []
    last = time.thread_time()
    deadline = time.perf_counter() + 0.2
    while len(rises) < 5 and time.perf_counter() < deadline:
        now = time.thread_time()
        if now != last:
            rises.append(now - last)
            last = now
    return 1e3 * min(rises, default=0.2)


def test_span_adds_wall_and_cpu_ms():
    stats = EncodeStats()
    b = spans.Binding(spans.Recorder(stats))
    with spans.Span(b, "nap", cpu=True) as s:
        time.sleep(0.05)
    with spans.Span(b, "wall") as w:
        time.sleep(0.01)
    assert stats.host_ms == {}
    b.flush()
    assert s.ms >= 50
    assert stats.host_ms["nap"] >= 50
    assert stats.cpu_ms["nap"] < 10 + _cpu_step_ms()
    assert w.ms >= 10 and set(stats.cpu_ms) == {"nap"}


def test_compress_fills_the_spans():
    data = _data()
    stats = EncodeStats()
    out = banzai_tpu_torch.compress(data, 1, "cpu", stats)
    assert out == banzai_tpu_torch.compress(data, 1, "cpu")
    assert stats.device_blocks >= 3
    want = {"dispatch", "sync", "bwt", "plan", *QUEUE_WAITS}
    assert want <= set(stats.host_ms)
    # Only dispatch reads the CPU clock; each of its spans may read up to
    # one step of that clock more than its wall time.
    assert set(stats.cpu_ms) == {"dispatch"}
    # The caller's own spans reach the stats too.
    assert stats.host_ms["caller_wait"] > 0
    slack = _cpu_step_ms() * stats.batches + 1
    assert 0 <= stats.cpu_ms["dispatch"] <= stats.host_ms["dispatch"] + slack
    assert stats.host_ms["bwt"] <= stats.host_ms["dispatch"]
    assert stats.host_ms["sync"] <= stats.host_ms["bwt"]
    assert stats.device_ms == {}


def _annotations(trace_path):
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("cat") == "user_annotation"]


def test_profiler_trace_holds_the_spans(tmp_path):
    """With every thread profiled, the spans of the scheduler's threads
    are in the trace, nested as they ran, each with the call's id and
    its batch index as inputs."""
    cfg = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True,
                 experimental_config=cfg) as prof:
        banzai_tpu_torch.compress(_data(), 1, "cpu")
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    ann = _annotations(tmp_path / "trace.json")
    by_name: dict = {}
    for e in ann:
        by_name.setdefault(e["name"], []).append(e)
    assert {"dispatch", "bwt", "plan", "sync", "device_wait_staged",
            "caller_wait"} <= set(by_name)
    main = threading.get_native_id()
    for name in ("dispatch", "bwt", "plan", "sync", "device_wait_staged"):
        assert all(e["tid"] != main for e in by_name[name]), name
    assert all(e["tid"] == main for e in by_name["caller_wait"])
    inputs = {e["name"]: e["args"]["Concrete Inputs"] for e in ann}
    call = inputs["caller_wait"][0]
    assert all(e["args"]["Concrete Inputs"][0] == call for e in ann)
    def inside(outer, e):
        return (outer["tid"] == e["tid"] and outer["ts"] <= e["ts"]
                and e["ts"] + e["dur"] <= outer["ts"] + outer["dur"])

    for b in by_name["bwt"]:
        outer = [d for d in by_name["dispatch"] if inside(d, b)]
        assert len(outer) == 1
        # A batch index, the same in the stage and its dispatch.
        assert (b["args"]["Concrete Inputs"][1]
                == outer[0]["args"]["Concrete Inputs"][1] != "-1")
    # Every wait for the device in a stage: the BWT's first reads and one
    # a round, the plan's and the payload entries' constant copies.
    for stage, least in (("bwt", 2), ("plan", 1), ("entries", 1)):
        for e in by_name[stage]:
            assert sum(inside(e, s) for s in by_name["sync"]) >= least, stage


def test_no_profiler_range_without_a_profiler(monkeypatch):
    entered = []

    def spy(*args):
        entered.append(args)
        raise AssertionError("a profiler range with no profiler running")

    monkeypatch.setattr(torch.autograd, "_record_function_with_args_enter",
                        spy)
    monkeypatch.setattr(torch.autograd.profiler.record_function, "__enter__",
                        spy)
    data = _data()
    stats = EncodeStats()
    out = banzai_tpu_torch.compress(data, 1, "cpu", stats)
    assert entered == []
    assert "dispatch" in stats.host_ms
    monkeypatch.undo()
    assert out == banzai_tpu_torch.compress(data, 1, "cpu")


def test_a_call_without_stats_times_nothing(monkeypatch):
    """With no stats and no profiler, no span is made on the scheduler's
    threads; only the caller's wait makes one, and it adds nothing."""
    made = []
    init = spans.Span.__init__

    def spy(self, *args, **kwargs):
        made.append((threading.get_native_id(), args[1]))
        init(self, *args, **kwargs)

    monkeypatch.setattr(spans.Span, "__init__", spy)
    data = _data()
    out = banzai_tpu_torch.compress(data, 1, "cpu")
    main = threading.get_native_id()
    assert made and all(m == (main, "caller_wait") for m in made)
    stats = EncodeStats()
    assert banzai_tpu_torch.compress(data, 1, "cpu", stats) == out
    assert {tid for tid, _n in made} - {main}
    assert "dispatch" in stats.host_ms


def test_encode_stats_routes_equal_compress():
    data = _data(6)
    want = EncodeStats()
    out = banzai_tpu_torch.compress(data, 1, "cpu", want)
    got = EncodeStats()
    w = io.BytesIO()
    banzai_tpu_torch.encode(io.BytesIO(data), w, 1, "cpu", stats=got)
    assert w.getvalue() == out
    assert [getattr(got, r) for r in ROUTES] == [getattr(want, r)
                                                 for r in ROUTES]
    assert got.host_tiny == 1 and got.device_blocks >= 3
    assert {"dispatch", "sync", *QUEUE_WAITS} <= set(got.host_ms)


@pytest.mark.parametrize("threads", [2, 8])
def test_span_sums_lose_nothing_across_threads(monkeypatch, threads):
    """Threads sharing one recorder under a short switch interval, on a
    clock that moves 1 s a reading on each thread: every span and read
    adds exactly 1000 ms, whether its thread's sums go to the stats at
    each bind (``span``, ``read_int``) or after each span (a binding of
    the thread's own), so a lost or doubled update shows in the sums."""
    local = threading.local()

    def clock():
        local.t = getattr(local, "t", 0.0) + 1.0
        return local.t

    monkeypatch.setattr(spans, "_wall", clock)
    stats = EncodeStats()
    rec = spans.Recorder(stats)
    n = 2_000

    one = torch.tensor(1)

    def body():
        own = spans.Binding(rec)
        for i in range(n):
            if i % 100 == 0:
                rec.bind(i)         # adds the sums so far
            with spans.span("tick"):
                pass
            assert spans.read_int(one) == 1
            with spans.Span(own, "tock"):
                pass
            own.flush()
        spans.flush()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=body) for _ in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    assert stats.host_ms == {"tick": 1e3 * threads * n,
                             "sync": 1e3 * threads * n,
                             "tock": 1e3 * threads * n}
