"""banzai_tpu_torch.parallel.spbwt (one block's BWT sharded over a list of
devices) vs the JAX package's bwt_rotations_sharded on its 8-device CPU
mesh, the port's one-device ops/bwt.bwt_rotations and the port's NumPy
oracles, on the CPU with D = 1, 2, 4 and 8 shards on "cpu".  Exact
equality: the BWT column and ptr are integers.

The cases are those of tests/test_spbwt.py.  Each JAX and one-device
reference runs once per input and is shared by the D cases.
"""

import functools
import itertools
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from banzai_tpu.parallel.spbwt import bwt_rotations_sharded as jax_sharded
from banzai_tpu.parallel.spbwt import lane_mesh
from banzai_tpu_torch.oracle import naive_bwt, numpy_bwt
from banzai_tpu_torch.ops.bwt import bwt_rotations
from banzai_tpu_torch.parallel.spbwt import (
    _merge_split, _to_positions, bwt_rotations_sharded,
)

ROOT = Path(__file__).resolve().parent.parent
DS = [1, 2, 4, 8]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: a round here is hundreds of small operations,
    and with several test processes on the host, threads that wait for
    each other at every operation make the file many times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _named() -> dict[str, bytes]:
    rng = np.random.default_rng(7)
    text = (ROOT / "banzai_tpu" / "parallel" / "spbwt.py").read_bytes()[:6000]
    return {
        "text": text,
        "random": rng.integers(0, 256, 5000, dtype=np.uint8).tobytes(),
        "periodic3": b"abc" * 2000,
        "run": b"z" * 4000,
        "run_rle1": b"zzzz\x05" * 800,
        "two": b"ba",
        "one": b"q",
        "alt": b"ab" * 3000,
    }


def _random(seed: int) -> tuple[bytes, int]:
    """tests/test_spbwt.py's random inputs: lengths at N/8 multiples +/- 1,
    so the shard edges fall at every kind of place."""
    rng = np.random.default_rng(100 + seed)
    N = 4096
    n = int(rng.choice([N, N - 1, N // 2, N // 2 + 1, 3 * N // 8 - 1,
                        N // 8 + 1]))
    kind = seed % 3
    if kind == 0:
        data = rng.integers(0, 256, n, dtype=np.uint8)
    elif kind == 1:
        data = rng.integers(0, 3, n, dtype=np.uint8)        # heavy ties
    else:
        p = rng.integers(2, 9)
        data = np.resize(rng.integers(0, 256, p, dtype=np.uint8), n)
    return data.tobytes(), N


def _period5() -> bytes:
    """The RLE1 period-5 pattern ("aaaaC" repeats) and a random tail."""
    rng = np.random.default_rng(11)
    tail = rng.integers(0, 256, 36_000).astype(np.uint8).tobytes()
    return b"aaaa\xfb" * 45_000 + tail


def _padded(data: bytes, N: int) -> np.ndarray:
    block = np.zeros(N, np.uint8)
    block[: len(data)] = np.frombuffer(data, np.uint8)
    return block


@functools.cache
def _jax(data: bytes, N: int) -> tuple[bytes, int]:
    bwt, ptr = jax_sharded(jnp.asarray(_padded(data, N)),
                           jnp.int32(len(data)), mesh=lane_mesh())
    return np.asarray(bwt)[: len(data)].tobytes(), int(ptr)


@functools.cache
def _one_device(data: bytes, N: int) -> tuple[bytes, int]:
    bwt, ptr = bwt_rotations(torch.from_numpy(_padded(data, N))[None],
                             torch.tensor([len(data)]))
    return bwt[0, : len(data)].numpy().tobytes(), int(ptr[0])


def _port(data: bytes, N: int, D: int, **kw):
    out = bwt_rotations_sharded(torch.from_numpy(_padded(data, N)), len(data),
                                devices=["cpu"] * D, **kw)
    assert len(out[0]) == D
    assert all(s.dtype == torch.uint8 and s.shape == (N // D,)
               for s in out[0])
    whole = torch.cat(out[0])
    assert not whole[len(data):].any()          # zeros past n
    return (whole[: len(data)].numpy().tobytes(), int(out[1])) + out[2:]


def _check(data: bytes, N: int, D: int) -> None:
    got = _port(data, N, D)
    bwt, ptr = numpy_bwt(data)
    assert got == _jax(data, N)
    assert got == _one_device(data, N)
    assert got == (bwt.tobytes(), ptr)


@pytest.mark.parametrize("D", DS)
@pytest.mark.parametrize("name", sorted(_named()))
def test_named_inputs_match(name, D):
    _check(_named()[name], 8192, D)


@pytest.mark.parametrize("D", DS)
@pytest.mark.parametrize("seed", range(6))
def test_random_lengths_straddling_shard_edges(seed, D):
    _check(*_random(seed), D)


@pytest.mark.parametrize("D", DS)
def test_stall_group_split_regression(D):
    """A round can split a tie group into smaller tie groups without
    resolving a lane: the stop rule compares group counts."""
    data = b"\x00" * 7 + b"\x01" + b"\x00" * 5 + b"\x01"
    _check(data, 16, D)
    assert _port(data, 16, D) == naive_bwt(data)


@functools.cache
def _one_device_binary(n: int) -> list[tuple[bytes, int]]:
    """The one-device BWT of every binary string of length n, one batch."""
    datas = [bytes(b) for b in itertools.product([0, 1], repeat=n)]
    blocks = torch.from_numpy(np.stack([_padded(d, 16) for d in datas]))
    bwt, ptr = bwt_rotations(blocks, torch.full((len(datas),), n))
    return [(bwt[i, :n].numpy().tobytes(), int(ptr[i]))
            for i in range(len(datas))]


@pytest.mark.parametrize("D", DS)
@pytest.mark.parametrize("n", range(1, 9))
def test_exhaustive_tiny_binary(n, D):
    """Every binary string of length n at N = 16: shards down to 2 lanes."""
    one = _one_device_binary(n)
    for i, bits in enumerate(itertools.product([0, 1], repeat=n)):
        data = bytes(bits)
        got = _port(data, 16, D)
        assert got == naive_bwt(data) == one[i] == _jax(data, 16), bits


@functools.cache
def _period5_k1() -> int:
    return _port(_period5(), 1 << 18, 1, debug_rounds=True)[2]


@pytest.mark.parametrize("D", DS)
def test_period5_rle1_block(D):
    """256K lanes of the RLE1 period-5 pattern: the same bytes, and the
    same stopping coverage k on every D, at most the next power of two
    >= n (plain doubling has no chain pass: k grows to the periodic
    region's length)."""
    data = _period5()
    N = 1 << 18
    *got, k = _port(data, N, D, debug_rounds=True)
    bwt, ptr = numpy_bwt(data)
    assert tuple(got) == _jax(data, N) == _one_device(data, N)
    assert tuple(got) == (bwt.tobytes(), ptr)
    assert k == _period5_k1()
    assert k <= 1 << (len(data) - 1).bit_length()


class _Sorts(TorchDispatchMode):
    """Counts the sorts an operation runs: one a doubling round."""

    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.count += func.overloadpacket is torch.ops.aten.sort
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("name", sorted(_named()))
def test_stop_rule_is_the_one_device_bwts(name):
    """At D = 1 the sharded loop stops at the coverage ops/bwt reaches:
    k = 2^(the one-device BWT's rounds, one sort each)."""
    data = _named()[name]
    with _Sorts() as sorts:
        _one_device.__wrapped__(data, 8192)
    assert _port(data, 8192, 1, debug_rounds=True)[2] == 1 << sorts.count


class _Largest(TorchDispatchMode):
    """Records the numel of the largest tensor any operation produces."""

    def __init__(self):
        super().__init__()
        self.numel = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.numel = max(self.numel, t.numel())
        return out


def test_million_lanes_no_tensor_past_two_shards():
    """2^20 lanes on 8 shards, passed in as shards: no operation makes a
    tensor of more than 2m lanes (a merge-split pair), and the bytes are
    the NumPy oracle's."""
    N, D = 1 << 20, 8
    m = N // D
    rng = np.random.default_rng(11)
    n = N - 777
    block = np.zeros(N, np.uint8)
    block[: n // 2] = rng.integers(32, 90, n // 2, dtype=np.uint8)
    per = np.frombuffer(b"ripple" * (n // 12), np.uint8)
    block[n // 2 : n // 2 + len(per)] = per
    block[n // 2 + len(per) : n] = rng.integers(
        0, 256, n - n // 2 - len(per), dtype=np.uint8)
    shards = [torch.from_numpy(block[d * m:(d + 1) * m].copy())
              for d in range(D)]
    with _Largest() as seen:
        bwt, ptr = bwt_rotations_sharded(shards, n, devices=["cpu"] * D)
    assert seen.numel <= 2 * m + 8, (seen.numel, m)
    ref_bwt, ref_ptr = numpy_bwt(block[:n])
    assert int(ptr) == ref_ptr
    np.testing.assert_array_equal(torch.cat(bwt)[:n].numpy(), ref_bwt)


@pytest.mark.parametrize("D", [2, 3, 4])
def test_shards_keep_m_lanes_between_rounds(D):
    """The merge-split and the scatter back to positions leave each shard
    m lanes of storage (m + 1 for the spill lane), not views of the 2m
    lanes of a merged pair: what a shard keeps stays O(N / D)."""
    m = 1000
    gen = torch.Generator().manual_seed(D)
    keys = [torch.randint(0, 50, (m,), generator=gen).sort().values
            for _ in range(D)]
    lanes = list((torch.randperm(D * m, generator=gen) << 8).split(m))
    want = torch.cat(keys).sort().values
    _merge_split(keys, lanes, ["cpu"] * D)
    assert torch.equal(torch.cat(keys), want)
    for t in keys + lanes:
        assert t.untyped_storage().nbytes() == 8 * m
    ranks = [torch.arange(d * m, (d + 1) * m) for d in range(D)]
    pos = _to_positions(lanes, ranks, [torch.device("cpu")] * D)
    whole = torch.cat(pos)
    assert torch.equal(whole[torch.cat(lanes) >> 8], torch.cat(ranks))
    for t in pos:
        assert t.shape == (m,) and t.untyped_storage().nbytes() == 8 * (m + 1)


def test_bad_input():
    block = torch.zeros(10, dtype=torch.uint8)
    with pytest.raises(ValueError, match="equal shards"):
        bwt_rotations_sharded(block, 5, devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="outside"):
        bwt_rotations_sharded(block, 11, devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="shards for"):
        bwt_rotations_sharded([block[:5]], 5, devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="uint8"):
        bwt_rotations_sharded(block.to(torch.int32), 5, devices=["cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            bwt_rotations_sharded(block, 5, devices=["cuda", "cuda"])
