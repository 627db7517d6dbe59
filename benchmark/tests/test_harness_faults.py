"""A run on the CPU, the look for a card skipped: a sound program comes
out correct, and with the timed path broken underneath it does not."""

from __future__ import annotations

import pytest
import torch

import banzai_tpu_torch.pipeline as pipeline
from conftest import run_tiny

SEED = 2**31 + 17


def test_sound_run_is_correct(tiny_repo):
    r = run_tiny(tiny_repo, SEED, seconds=4.0)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 2 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    assert set(r["metrics"]) == {"throughput", "bits_per_byte", "setup_s"}   # job_p95_s: l1-silesia only


def _flip_word(out):
    words = out[0].clone()
    words[0, 3] ^= 1 << 7                       # one payload bit of row 0
    return (words, *out[1:])


def _half_batch(out):
    words = out[0].clone()
    B = words.shape[0]
    if B > 1:
        words[B // 2 :] = words[: B - B // 2]   # the rest copies the first half
    return (words, *out[1:])


FAULTS = {"answer_altered": _flip_word, "half_batch_left_out": _half_batch}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_in_the_device_body_is_caught(tiny_repo, monkeypatch, fault):
    body = pipeline.encode_batch_rows

    def broken(rows, **kw):
        return FAULTS[fault](body(rows, **kw))

    monkeypatch.setattr(pipeline, "encode_batch_rows", broken)
    r = run_tiny(tiny_repo, SEED, warm=False)
    assert not r["correct"]
    assert r["checks"]["stream_mismatch_jobs"]["value"] > 0


def test_exchange_between_devices_left_out_is_caught(tiny_repo, monkeypatch):
    """Two device threads; the second one's batches never come back
    whole: its words are zeros when they reach the caller."""
    run_batch = pipeline._Scheduler._run_batch

    def lost(self, dev, group, rows_h, pres):
        item = run_batch(self, dev, group, rows_h, pres)
        if torch.cuda.is_available() or not self.devs[1:]:
            return item
        import threading
        if threading.current_thread().name.endswith("device1"):
            host = item[3].clone()
            host[4 * len(group) + 3 * 258 * len(group):] = 0
            item = (*item[:3], host, *item[4:])
        return item

    monkeypatch.setattr(pipeline._Scheduler, "_run_batch", lost)
    r = run_tiny(tiny_repo, SEED, seconds=3.0, devices=["cpu", "cpu"], warm=False)
    assert not r["correct"]
    assert r["checks"]["stream_mismatch_jobs"]["value"] > 0


def test_failed_jobs_make_a_run_incorrect(tiny_repo, monkeypatch):
    def boom(rows, **kw):
        raise RuntimeError("device batch failed")

    monkeypatch.setattr(pipeline, "encode_batch_rows", boom)
    r = run_tiny(tiny_repo, SEED, seconds=0.5, warm=False)
    assert not r["correct"]
    assert r["failed"] == r["attempted"] >= 1
