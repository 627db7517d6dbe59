"""The reader of ``plan_kernel_share`` on synthetic ``EncodeStats``, and
on stats of a program without the counter."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from banzai_tpu_torch.pipeline import EncodeStats
from benchmark import harness, spec, window


def run_with(stats):
    data = harness.RunData(spec.cell(spec.load(), "l9-silesia"), 9, 1.0, [])
    data.parts["host"] = harness.Part(window.Window([], 1.0), stats)
    return data


def read(run):
    return spec.reader("plan_kernel_share").read(run)


@pytest.mark.parametrize("planned,blocks,share", [
    (40, 40, 100.0), (30, 40, 75.0), (0, 12, 0.0),
])
def test_share_of_the_device_blocks(planned, blocks, share):
    st = EncodeStats(device_blocks=blocks, plan_kernel_blocks=planned,
                     host_banzai=3, host_tiny=2)
    assert read(run_with(st)) == pytest.approx(share)


def test_nothing_without_the_counter_or_a_device_block():
    parent = SimpleNamespace(device_blocks=40, host_ms={}, stage_ms=None)
    assert read(run_with(parent)) is None
    assert read(run_with(EncodeStats(device_blocks=0))) is None
    assert read(harness.RunData(run_with(parent).cell, 9, 1.0, [])) is None


def test_reported_in_both_cells():
    bench = spec.load()
    for cell in ("l9-silesia", "l1-silesia"):
        assert "plan_kernel_share" in [m["name"]
                                       for m in spec.cell(bench, cell).per_layer]
    entry = {m["name"]: m for m in bench["per_layer"]}["plan_kernel_share"]
    assert (entry["unit"], entry["better"], entry["source"], entry["layer"],
            entry["moves"]) == ("%", "higher", "program_counter",
                                "block stages", "throughput")
