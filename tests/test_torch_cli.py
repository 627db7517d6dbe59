"""The port's CLI (``python -m banzai_tpu_torch.cli``) on the CPU
(``--device cpu``): the cases of ``tests/test_cli.py`` that concern the
CLI's own behaviour, plus the device flag."""

import bz2
import os
import random
import subprocess
import sys
import threading
from pathlib import Path

import pytest
import torch

from banzai_tpu.encoder_host import compress as host_compress
from banzai_tpu.oracle import banzai_compress
from banzai_tpu_torch import cli, pipeline
from banzai_tpu_torch.cli import (
    EXIT_INPUT_IO, EXIT_OK, EXIT_OUTPUT_IO, EXIT_USAGE, parse_args,
)

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("argv,want", [
    (["file.txt"], dict(input="file.txt", level=9, keep_inf=None,
                        stdout=False, device="cuda")),
    (["-kc9", "x"], dict(keep_inf=True, stdout=True, level=9)),
    (["-k", "-r", "x"], dict(keep_inf=False)),
    (["-r", "--keep", "x"], dict(keep_inf=True)),
    (["--fast", "--output", "out.bz2", "in"], dict(level=1,
                                                   output="out.bz2")),
    (["--", "-weird-name"], dict(input="-weird-name")),
    (["-c", "-"], dict(input="-", stdout=True)),
    (["--device", "cpu", "-v", "--banzai-compat", "x"],
     dict(device="cpu", verbose=True, banzai_compat=True)),
    (["--device", "cuda:1", "x"], dict(device="cuda:1")),
    (["--device", "cuda:0,cuda:1,cuda", "x"],
     dict(device="cuda:0,cuda:1,cuda")),
    (["--device", "cpu,cpu", "x"], dict(device="cpu,cpu")),
], ids=["defaults", "combined", "keep_then_remove", "remove_then_keep",
        "alias_output", "end_of_flags", "stdin", "device", "device_index",
        "device_cards", "device_cpus"])
def test_parse(argv, want):
    inv = parse_args(argv)
    for name, value in want.items():
        assert getattr(inv, name) == value, name


@pytest.mark.parametrize("argv", [
    [], ["-x", "f"], ["a", "b"], ["--output"], ["--device"],
    ["--device", "tpu", "f"], ["--nope", "f"],
])
def test_parse_errors(argv, capsys):
    assert parse_args(argv) == EXIT_USAGE
    assert cli.main(argv) == EXIT_USAGE
    assert "bnz:" in capsys.readouterr().err


def _run(args, data=None):
    return subprocess.run(
        [sys.executable, "-m", "banzai_tpu_torch.cli", "--device", "cpu",
         *args],
        capture_output=True, cwd=ROOT, input=data, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(ROOT)),
    )


def test_cli_roundtrip(tmp_path):
    src = tmp_path / "data.txt"
    payload = b"the quick brown fox " * 200 + random.Random(1).randbytes(
        120_000)
    src.write_bytes(payload)
    p = _run(["-k", "-1", str(src)])
    assert p.returncode == EXIT_OK, p.stderr
    out = (tmp_path / "data.txt.bz2").read_bytes()
    assert out == host_compress(payload, 1, jobs=1)
    assert bz2.decompress(out) == payload
    assert src.exists()


def test_cli_stdin_defaults_to_stdout():
    payload = b"stdin to stdout " * 100
    p = _run(["-1", "-"], data=payload)
    assert p.returncode == EXIT_OK, p.stderr
    assert p.stdout == host_compress(payload, 1, jobs=1)


@pytest.mark.parametrize("flags,kept,out_name", [
    ([], False, "f.txt.bz2"),
    (["--output", "{dst}"], True, "f.out"),
    (["-r", "--output", "{dst}"], False, "f.out"),
    (["-k"], True, "f.txt.bz2"),
    (["-c"], True, None),
], ids=["default_deletes", "output_keeps", "remove_overrides_output",
        "keep", "stdout_keeps"])
def test_cli_deletion_policy(tmp_path, capsysbinary, flags, kept, out_name):
    src = tmp_path / "f.txt"
    data = b"abc" * 100
    src.write_bytes(data)
    dst = tmp_path / "f.out"
    argv = ["--device", "cpu", "-1"] + [
        a.format(dst=dst) for a in flags] + [str(src)]
    assert cli.main(argv) == EXIT_OK
    assert src.exists() == kept
    want = host_compress(data, 1, jobs=1)
    if out_name is None:
        assert capsysbinary.readouterr().out == want
    else:
        assert (tmp_path / out_name).read_bytes() == want


def test_cli_missing_input_exits_2(tmp_path, capsys):
    rc = cli.main(["--device", "cpu", str(tmp_path / "absent.txt")])
    assert rc == EXIT_INPUT_IO
    assert "cannot read" in capsys.readouterr().err


@pytest.mark.parametrize("case", ["deletion_fails", "same_file"])
def test_cli_output_side_failures_exit_3(tmp_path, monkeypatch, capsys,
                                         case):
    src = tmp_path / "k.txt"
    src.write_bytes(b"data" * 30)
    if case == "deletion_fails":
        monkeypatch.setattr(
            cli.os, "unlink",
            lambda p: (_ for _ in ()).throw(OSError("unlink denied")),
        )
        argv, msg = ["-1", str(src)], "deleting"
    else:
        argv, msg = ["-1", "--output", str(src), str(src)], "same as output"
    assert cli.main(["--device", "cpu", *argv]) == EXIT_OUTPUT_IO
    assert msg in capsys.readouterr().err
    assert src.read_bytes() == b"data" * 30


def test_cli_verbose_emits_block_stats(tmp_path, capsys):
    src = tmp_path / "v.txt"
    src.write_bytes(b"verbose me " * 500)
    assert cli.main(["--device", "cpu", "-v", "-k", "-1", str(src)]) == 0
    err = capsys.readouterr().err
    assert "block 0:" in err and "rle1" in err


def test_banzai_compat_flag(tmp_path, capsysbinary):
    data = b"compat test " * 400
    src = tmp_path / "in.bin"
    src.write_bytes(data)
    rc = cli.main(["-k", "--banzai-compat", "-1", "-c", str(src)])
    assert rc == EXIT_OK
    out = capsysbinary.readouterr().out
    assert out == banzai_compress(data, 1)
    assert bz2.decompress(out) == data


def test_cli_failed_device_batch_exits_3_no_partial(tmp_path, monkeypatch,
                                                    capsys):
    def boom(*args, **kwargs):
        raise RuntimeError("device batch failed")

    monkeypatch.setattr(pipeline, "encode_batch_rows", boom)
    src = tmp_path / "boom.txt"
    src.write_bytes(random.Random(2).randbytes(150_000))
    assert cli.main(["--device", "cpu", "-k", "-1", str(src)]) == (
        EXIT_OUTPUT_IO)
    err = capsys.readouterr().err
    assert "error during compression: device batch failed" in err
    assert "Traceback" not in err
    assert not (tmp_path / "boom.txt.bz2").exists()
    assert [t for t in threading.enumerate()
            if t.name.startswith("banzai_tpu_torch-")] == []


def test_cli_cuda_without_a_card_exits_3(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src = tmp_path / "c.txt"
    src.write_bytes(b"no card " * 100)
    assert cli.main(["-1", str(src)]) == EXIT_OUTPUT_IO
    err = capsys.readouterr().err
    assert err.count("\n") == 1 and "CUDA is not available" in err
    assert src.exists() and not (tmp_path / "c.txt.bz2").exists()


@pytest.mark.parametrize("entry", ["encode", "cli"])
def test_never_imports_jax(tmp_path, entry):
    data = bytes(range(256)) * 100
    src = tmp_path / "in.bin"
    src.write_bytes(data)
    if entry == "encode":
        run = ("import io, banzai_tpu_torch\n"
               "w = io.BytesIO()\n"
               f"banzai_tpu_torch.encode(open({str(src)!r}, 'rb'), w, 1, "
               "'cpu', span_bytes=10_000)\n"
               "out = w.getvalue()\n")
    else:
        run = ("import runpy\n"
               f"sys.argv = ['bnz', '--device', 'cpu', '-k', '-1', "
               f"{str(src)!r}]\n"
               "try:\n"
               "    runpy.run_module('banzai_tpu_torch.cli', "
               "run_name='__main__', alter_sys=True)\n"
               "except SystemExit as e:\n"
               "    assert e.code == 0, e.code\n"
               f"out = open({str(src)!r} + '.bz2', 'rb').read()\n")
    code = ("import sys, bz2\n" + run
            + "assert bz2.decompress(out) == bytes(range(256)) * 100\n"
            "assert 'jax' not in sys.modules, 'jax imported'\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr


def test_fuzz_driver_runs_clean(tmp_path, monkeypatch, capsys):
    from banzai_tpu_torch import fuzz

    monkeypatch.chdir(tmp_path)
    assert fuzz.main(["6", "--device", "cpu", "--seed", "5"]) == 0
    assert "6 iterations clean" in capsys.readouterr().out
    assert not (tmp_path / "fuzz_fail.bin").exists()


def test_cli_device_list_gives_the_same_stream(tmp_path):
    """--device cpu,cpu runs two device threads: the stream is --device
    cpu's and the host encoder's."""
    payload = random.Random(3).randbytes(150_000) + b"ab" * 80_000
    outs = []
    for i, device in enumerate(["cpu", "cpu,cpu"]):
        src = tmp_path / f"in{i}.bin"
        src.write_bytes(payload)
        assert cli.main(["-k", "-1", "--device", device, str(src)]) == EXIT_OK
        outs.append((tmp_path / f"in{i}.bin.bz2").read_bytes())
    assert outs[0] == outs[1] == host_compress(payload, 1, jobs=1)


@pytest.mark.parametrize("value", [
    "gpu", "cuda:x", "cuda:", "cpu,", ",cpu", "cpu,,cpu", "cpu:0", "cuda:-1",
    "cpu,cuda:0", "cuda:0,cpu", "", "CUDA",
])
def test_cli_malformed_device_exits_usage_no_output(tmp_path, capsys, value):
    src = tmp_path / "m.txt"
    src.write_bytes(b"malformed device " * 100)
    assert cli.main(["-1", "--device", value, str(src)]) == EXIT_USAGE
    assert "--device must be" in capsys.readouterr().err
    assert src.exists() and not (tmp_path / "m.txt.bz2").exists()


def test_cli_card_past_the_visible_ones_exits_3(tmp_path, monkeypatch,
                                                capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    src = tmp_path / "n.txt"
    src.write_bytes(b"no such card " * 100)
    assert cli.main(["-1", "--device", "cuda:0,cuda:3", str(src)]) == (
        EXIT_OUTPUT_IO)
    err = capsys.readouterr().err
    assert err.count("\n") == 1 and "only 1 CUDA devices" in err
    assert src.exists() and not (tmp_path / "n.txt.bz2").exists()
