"""The control: the reference in the program's place with its plan cut
to 2-3 tables and no banzai candidate must come out as not correct."""

from __future__ import annotations

from benchmark.control import CONTROL_PLAN
from benchmark.reference.encoder import compress_many
from conftest import run_tiny


def test_control_comes_out_not_correct(tiny_repo):
    def encode(data, stats=None, device=None):
        return compress_many([data], 1, plan=CONTROL_PLAN)[0]

    for seed in (2**31 + 1, 2**31 + 2, 2**31 + 3):
        r = run_tiny(tiny_repo, seed, seconds=1.0, encode=encode, warm=False)
        assert not r["correct"]
        c = r["checks"]
        assert c["stream_mismatch_jobs"]["value"] > c["stream_mismatch_jobs"]["limit"]
        assert c["roundtrip_fail_jobs"]["value"] == 0      # it still decodes
