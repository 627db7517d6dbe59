"""banzai_tpu_torch's multi-process encode on the CPU: real gloo process
groups of 2, 3 and 4 ranks, each rank a process of
``python -m banzai_tpu_torch.parallel._worker --device cpu``, at level 1
on ``tests/test_multihost.py``'s corpus (about 209 KB).  Rank 0's stream
must equal the JAX package's device pipeline (its sharded path over the
8 CPU devices ``conftest.py`` forces) and the port's ``compress``."""

import bz2
import json

import pytest

import banzai_tpu_torch
from banzai_tpu_torch.parallel._worker import run_ranks
from test_multihost import _corpus

# The report's keys, as banzai_tpu/parallel/multihost.py fills them.
JAX_REPORT_KEYS = {
    "nproc", "input_bytes", "span_wait_s", "encode_s", "plan_scan_s",
    "gather_s", "dcn_payload_bytes", "modeled_single_host_s",
    "modeled_parallel_s", "modeled_efficiency",
}


@pytest.fixture(scope="module")
def corpus():
    data = _corpus()
    assert len(data) == 209_388
    return data


@pytest.fixture(scope="module")
def jax_stream(corpus):
    from banzai_tpu.pipeline import compress

    return compress(corpus, 1)


def _run(tmp_path, data, nproc, report=False):
    src, dst = tmp_path / "input.bin", tmp_path / "multi.bz2"
    rep = tmp_path / "report.json" if report else None
    src.write_bytes(data)
    lines = run_ranks(str(src), str(dst), 1, ["cpu"] * nproc,
                      report_path=rep, timeout=300)
    assert [ln["rank"] for ln in lines] == list(range(nproc))
    assert all(ln["device"] == ["cpu"] and ln["launches"] == {}
               for ln in lines)
    return dst.read_bytes(), json.loads(rep.read_text()) if report else None


@pytest.mark.parametrize("nproc", [2, 3])
def test_ranks_match_jax_pipeline_and_compress(tmp_path, corpus, jax_stream,
                                               nproc):
    out, _ = _run(tmp_path, corpus, nproc)
    assert out == jax_stream
    assert out == banzai_tpu_torch.compress(corpus, 1, "cpu")
    assert bz2.decompress(out) == corpus


def test_four_ranks_report(tmp_path, corpus, jax_stream):
    out, report = _run(tmp_path, corpus, 4, report=True)
    assert out == jax_stream
    assert set(report) == JAX_REPORT_KEYS
    assert report["nproc"] == 4 and report["input_bytes"] == len(corpus)
    assert len(report["span_wait_s"]) == len(report["encode_s"]) == 4
    # Planning is pipelined: no rank waited for the whole scan before its
    # span arrived.
    assert max(report["span_wait_s"]) < report["modeled_parallel_s"] / 2
    # What is gathered is the compressed payloads, not the input.
    assert report["dcn_payload_bytes"] < len(corpus) / 2
    assert report["modeled_single_host_s"] > 0


def test_a_failed_rank_fails_the_run(tmp_path, corpus):
    """Rank 1 asks for a card this machine lacks: the run raises with its
    error, and rank 0 is killed rather than left waiting."""
    src = tmp_path / "input.bin"
    src.write_bytes(corpus)
    with pytest.raises(RuntimeError,
                       match="(?s)rank 1 exited 1.*CUDA is not available"):
        run_ranks(str(src), str(tmp_path / "out.bz2"), 1, ["cpu", "cuda"],
                  timeout=300)
    assert not (tmp_path / "out.bz2").exists()
