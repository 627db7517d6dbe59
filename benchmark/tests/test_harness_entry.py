"""``run.py`` refuses to run without its cards or without the program,
and prints no result."""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from conftest import REPO, copy_benchmark

ARGS = ["--workload", "l9-silesia", "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"]


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")


def run(cwd: Path):
    return subprocess.run([sys.executable, "benchmark/run.py", *ARGS], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_without_a_card_exits_nonzero_with_no_result(no_card):
    r = run(REPO)
    assert r.returncode != 0
    assert r.stdout == ""
    assert "CUDA card" in r.stderr


def test_without_the_program_exits_nonzero_with_no_result(tmp_path):
    r = run(copy_benchmark(tmp_path))
    assert r.returncode != 0
    assert r.stdout == ""
