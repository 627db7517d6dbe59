"""The readers of the program's own spans and device marks, on synthetic
``EncodeStats``, and on stats of a program that has none of them."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from banzai_tpu_torch.pipeline import EncodeStats
from benchmark import harness, pool, spec, window

NEW = ("bwt_device_ms_per_MB", "plan_device_ms_per_MB", "batch_gap_ms_per_MB",
       "starved_gap_ms_per_MB", "sync_wait_ms_per_MB", "dispatch_offcpu_ms_per_MB")


def read(name, run):
    return spec.reader(name).read(run)


def run_with(stats):
    t = pool.load_traffic("silesia-mix")
    t["pool_bytes"] = 1 << 20
    t["job_bytes"] = {"min": 100_000, "max": 300_000, "classes": 2}
    jobs = [j for j, _ in zip(pool.jobs(t, 3), range(4))]
    done = [window.Done(j, 0.1, b"x") for j in jobs]
    data = harness.RunData(spec.cell(spec.load(), "l9-silesia"), 9, 1.0, [])
    data.parts["host"] = harness.Part(window.Window(done, 1.0), stats)
    return data


def card_stats():
    st = EncodeStats()
    st.host_ms.update(dispatch=500.0, sync=120.0, bwt=200.0, plan=150.0)
    st.cpu_ms.update(dispatch=300.0)
    st.device_ms.update(bwt=60.0, plan=90.0, gap=400.0, gap_starved=70.0)
    return st


def test_readers_of_a_card_run():
    run = run_with(card_stats())
    mb = run.parts["host"].mb
    assert read("bwt_device_ms_per_MB", run) == pytest.approx(60.0 / mb)
    assert read("plan_device_ms_per_MB", run) == pytest.approx(90.0 / mb)
    assert read("batch_gap_ms_per_MB", run) == pytest.approx(400.0 / mb)
    assert read("starved_gap_ms_per_MB", run) == pytest.approx(70.0 / mb)
    assert read("sync_wait_ms_per_MB", run) == pytest.approx(120.0 / mb)
    # 500 ms in dispatch, 300 of them on the CPU.
    assert read("dispatch_offcpu_ms_per_MB", run) == pytest.approx(200.0 / mb)
    assert read("starved_gap_ms_per_MB", run) <= read("batch_gap_ms_per_MB", run)
    assert read("dispatch_offcpu_ms_per_MB", run) <= read("dispatch_ms_per_MB", run)


def test_a_cpu_run_has_no_device_readings():
    st = card_stats()
    st.device_ms.clear()
    run = run_with(st)
    for name in NEW[:4]:
        assert read(name, run) is None
    assert read("sync_wait_ms_per_MB", run) is not None
    assert read("dispatch_offcpu_ms_per_MB", run) is not None


@pytest.mark.parametrize("name", NEW)
def test_nothing_to_read_in_a_program_without_the_spans(name):
    """The stats of a program with only ``host_ms`` (no ``cpu_ms``,
    ``device_ms`` or ``sync``): no reading, and no error."""
    old = SimpleNamespace(host_ms={"dispatch": 500.0, "stage": 20.0}, stage_ms=None)
    assert read(name, run_with(old)) is None
    assert read(name, harness.RunData(run_with(old).cell, 9, 1.0, [])) is None


def test_each_new_metric_is_reported_in_both_cells():
    bench = spec.load()
    for cell in ("l9-silesia", "l1-silesia"):
        names = [m["name"] for m in spec.cell(bench, cell).per_layer]
        assert set(NEW) <= set(names)
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in NEW:
        m = entries[name]
        assert (m["unit"], m["better"], m["source"], m["moves"]) == \
            ("ms/MB", "lower", "program_span", "throughput")
        assert "workloads" not in m
