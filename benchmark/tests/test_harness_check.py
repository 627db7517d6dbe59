"""What ``correct`` reads: every stream decoded, a sample that covers each
device thread, and configurations that say only what the harness runs."""

from __future__ import annotations

import json

import pytest

from benchmark import check, harness, spec
from benchmark.window import Done

from conftest import TINY_CONFIG, run_tiny

SEED = 2**31 + 29


class FakeJob:
    def __init__(self, size):
        self.size = size


def done_on(devices: list[tuple]) -> list:
    return [Done(FakeJob(1000 + i), 0.1, b"x", 0.1 * i, dev) for i, dev in enumerate(devices)]


@pytest.mark.parametrize("seed", [1, 2**31 + 3, 2**40 + 5])
def test_sample_covers_every_device_thread_that_ran_a_batch(seed):
    # Four device threads; the last two work on one job each.
    devices = [(2, 1, 0, 0)] * 40 + [(1, 1, 1, 0)] + [(0, 2, 0, 0)] * 20 + [(1, 0, 0, 1)]
    done = done_on(devices)
    picked = check.sample(done, seed)
    assert picked == check.sample(done, seed)
    assert picked[0] is done[-1]                       # the largest job
    for dev in range(4):
        assert any(d.devices[dev] > 0 for d in picked), dev
    assert len(picked) <= check.SAMPLE + 4


def test_sample_without_device_counts_is_the_largest_and_the_seed_draw():
    done = done_on([()] * 10)
    picked = check.sample(done, 7)
    assert len(picked) == check.SAMPLE and picked[0] is done[-1]


def test_every_stream_is_decoded(tiny_repo):
    """Streams broken outside the sample are caught by the round trip."""
    cfg = {**TINY_CONFIG}
    encode = harness.program(cfg, "cpu")
    broken = []

    def every_other_broken(data, stats=None, device=None):
        out = encode(data, stats, device)
        if stats is None:                  # the warm-up
            return out
        if len(broken) % 2:
            out = out[:-5]
        broken.append(len(broken) % 2)
        return out

    r = run_tiny(tiny_repo, SEED, seconds=3.0, encode=every_other_broken)
    assert not r["correct"]
    assert r["checks"]["roundtrip_jobs"]["value"] == len(broken)
    assert r["checks"]["roundtrip_fail_jobs"]["value"] == sum(broken) >= 1


def test_compress_arguments_come_from_the_configuration(monkeypatch):
    import banzai_tpu_torch

    seen = {}

    def fake(data, level, device, stats, **kw):
        seen.update(level=level, device=device, **kw)
        return b""

    monkeypatch.setattr(banzai_tpu_torch, "compress", fake)
    cfg = {**TINY_CONFIG, "compress": {"batch": 4, "hybrid_jobs": 2}}
    harness.check_config(cfg)
    harness.program(cfg, "cpu")(b"abc")
    assert seen == {"level": 1, "device": "cpu", "batch": 4, "hybrid_jobs": 2}


def test_a_configuration_key_the_harness_would_ignore_is_refused(tiny_repo):
    path = tiny_repo / "benchmark" / "configs" / "tiny-cpu.json"
    path.write_text(json.dumps({**TINY_CONFIG, "hybrid_jobs": 2}))
    with pytest.raises(ValueError, match="hybrid_jobs"):
        run_tiny(tiny_repo, SEED)


@pytest.mark.parametrize("name", sorted(p.stem for p in (spec.ROOT / "configs").glob("*.json")))
def test_every_cell_configuration_is_one_the_harness_runs(name):
    with open(spec.ROOT / "configs" / f"{name}.json") as f:
        harness.check_config(json.load(f))
