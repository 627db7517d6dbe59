"""The plain reference against the port's host encoder (compared here
only: the reference imports nothing of the port)."""

from __future__ import annotations

import bz2

import numpy as np
import pytest

from banzai_tpu_torch import encoder_host
from banzai_tpu_torch.mtf_rle2 import mtf_indices as port_mtf
from banzai_tpu_torch.oracle.stages import numpy_bwt
from benchmark import pool
from banzai_tpu_torch.rle1 import split_blocks as port_split
from benchmark.reference import bwt as ref_bwt
from benchmark.reference import encoder, rle1
from benchmark.reference.mtf_rle2 import mtf_indices as ref_mtf


def inputs():
    rng = np.random.default_rng(0)
    t = pool.load_traffic("silesia-mix")
    t["pool_bytes"] = 1 << 19
    parts = pool.build_pool(t, 1)
    lengths = rng.integers(1, 600, 2000)
    runs = np.repeat(rng.integers(0, 4, len(lengths), dtype=np.uint8), lengths)
    return {
        "empty": b"", "one": b"a", "run4": b"aaaa", "run300": b"a" * 300,
        "period5": b"abcde" * 30000, "zeros": bytes(150000),
        "random": rng.integers(0, 256, 120000, dtype=np.uint8).tobytes(),
        "silesia": b"".join(parts)[:250000],
        "runs": runs[:250000].tobytes(),
    }


CASES = inputs()


@pytest.mark.parametrize("level", [1, 9])
@pytest.mark.parametrize("name", sorted(CASES))
def test_reference_stream_equals_the_port_host_encoder(name, level):
    data = CASES[name]
    want = encoder_host.compress(data, level, jobs=1)
    got = encoder.compress(data, level)
    assert got == want
    assert bz2.decompress(got) == data


def test_reference_streams_of_many_inputs_in_order():
    datas = [CASES["silesia"], CASES["one"], CASES["runs"]]
    assert encoder.compress_many(datas, 1) == [encoder_host.compress(d, 1, jobs=1) for d in datas]


def test_bwt_matches_the_port_numpy_bwt():
    rng = np.random.default_rng(3)
    blocks = [b"banana", b"abab", bytes(9), b"abcdefghi" * 3]
    blocks += [rng.integers(0, k, n, dtype=np.uint8).tobytes()
               for n in (1, 2, 7, 8, 9, 31, 500) for k in (1, 2, 3, 256)]
    for blk in blocks:
        want = numpy_bwt(blk)
        got = ref_bwt.bwt(blk)
        assert np.array_equal(got[0], want[0]) and got[1] == want[1], blk


def test_mtf_matches_the_port_mtf():
    rng = np.random.default_rng(4)
    for n in (1, 5, 600, 5000):
        for k in (1, 2, 7, 256):
            col = rng.integers(0, k, n).astype(np.uint8)
            col[: n // 3] = col[0]                     # a long run
            present = np.zeros(256, bool)
            present[col] = True
            assert np.array_equal(ref_mtf(col, present), port_mtf(col, present))


def test_control_plan_changes_the_stream_but_still_decodes():
    data = CASES["silesia"]
    got = encoder.compress(data, 1, plan=((2, 3), False))
    assert got != encoder_host.compress(data, 1, jobs=1)
    assert bz2.decompress(got) == data


def runs_of(rng, n: int) -> bytes:
    """Runs of a few byte values, of lengths drawn to meet the machine's
    edges: 1-3, 4, 255-260 and 510-511, and long ones."""
    kind = rng.integers(0, 3)
    if kind == 0:
        lengths = rng.integers(1, 700, n // 50 + 2)
    elif kind == 1:
        lengths = rng.choice([1, 2, 3, 4, 5, 255, 256, 257, 258, 259, 260, 510, 511], n // 20 + 2)
    else:
        lengths = rng.geometric(0.3, n // 2 + 2)
    vals = rng.integers(0, rng.integers(1, 5), len(lengths), dtype=np.uint8)
    return np.repeat(vals, lengths)[:n].tobytes()


def machine_blocks(data: bytes, cap: int) -> list:
    """The split by the byte-serial machine alone."""
    out, offset = [], 0
    while offset < len(data):
        o, end = rle1.machine_replay(data, offset, offset, cap)
        out.append((bytes(o), end - offset))
        offset = end
    return out


@pytest.mark.parametrize("seed", range(6))
def test_rle1_split_equals_the_machine_at_small_bounds(seed):
    rng = np.random.default_rng([seed, 21])
    for _ in range(40):
        data = runs_of(rng, int(rng.integers(1, 20000)))
        cap = int(rng.choice([5, 9, 50, 601, 650, 1000, 1500, 4000]))
        got = [(b.output.tobytes(), b.consumed) for b in rle1.iter_blocks(data, 1, cap=cap)]
        assert got == machine_blocks(data, cap), cap


@pytest.mark.parametrize("name", ["runs", "silesia", "zeros", "random"])
def test_rle1_split_equals_the_port(name):
    data = CASES[name] * 2
    for level in (1, 2):
        got = [(b.output.tobytes(), b.consumed, b.crc) for b in rle1.iter_blocks(data, level)]
        want = [(b.output.tobytes(), b.consumed, b.crc) for b in port_split(data, level)]
        assert got == want
