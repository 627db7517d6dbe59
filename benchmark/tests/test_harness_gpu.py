"""On the card: one short run of each one-card cell comes out correct
(run with ``pytest -m gpu`` on a machine with an H100)."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from conftest import REPO


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["l9-silesia", "l1-silesia"])
def test_short_run_is_correct(card, workload):
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload", workload,
                        "--seed", str(2**31 + 77), "--seconds", "3", "--trace", "0"],
                       cwd=REPO, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    result = json.loads(r.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
