"""banzai_tpu_torch MTF vs the JAX package (XLA path and the Pallas kernel
in interpret mode) and the host twin, on the CPU.  Exact equality."""

from functools import partial

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from banzai_tpu.mtf_rle2 import mtf_indices as host_mtf
from banzai_tpu.ops.mtf import mtf_indices_device
from banzai_tpu.ops.mtf_pallas import mtf_shuffle_pallas
from banzai_tpu_torch import _build
from banzai_tpu_torch.ops.mtf import mtf_indices
from banzai_tpu_torch.ops.mtf_kernel import mtf_shuffle, mtf_shuffle_plain

N = 4096
CHUNK = 64


@pytest.mark.parametrize("seed,n,alpha", [(0, 100, 3), (1, 4000, 256),
                                          (2, 4096, 2), (3, 1, 1)])
def test_mtf_indices_match_jax_and_host(seed, n, alpha):
    rng = np.random.default_rng(seed)
    arr = rng.integers(0, alpha, n).astype(np.uint8)
    present = np.zeros(256, bool)
    present[arr] = True
    block = np.zeros(N, np.uint8)
    block[:n] = arr
    got = mtf_indices(
        torch.from_numpy(block)[None], torch.tensor([n]),
        torch.from_numpy(present)[None], CHUNK,
    )[0].numpy()
    f = partial(mtf_indices_device, chunk=CHUNK)
    want = np.asarray(f(jnp.asarray(block), jnp.int32(n), jnp.asarray(present)))
    np.testing.assert_array_equal(got[:n], want[:n])
    np.testing.assert_array_equal(got[:n], host_mtf(arr, present))
    assert (got[n:] == -1).all()


def _shuffle_case(C=64, K=CHUNK, seed=5):
    rng = np.random.default_rng(seed)
    syms = np.full((C, K), -1, np.int32)
    for c in range(C):
        k = int(rng.integers(1, K + 1))
        syms[c, :k] = rng.integers(0, 256, k)
    state0 = np.stack([rng.permutation(256) for _ in range(C)]).astype(np.int32)
    return syms, state0


def test_shuffle_matches_pallas_interpret():
    syms, state0 = _shuffle_case()
    got = mtf_shuffle(torch.from_numpy(syms), torch.from_numpy(state0))
    want = mtf_shuffle_pallas(
        jnp.asarray(syms), jnp.asarray(state0), interpret=True
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_shuffle_cpu_tensor_takes_plain_version():
    syms, state0 = _shuffle_case(C=4)
    before = _build.LAUNCHES["mtf_shuffle"]
    got = mtf_shuffle(torch.from_numpy(syms), torch.from_numpy(state0))
    assert _build.LAUNCHES["mtf_shuffle"] == before
    np.testing.assert_array_equal(
        got.numpy(),
        mtf_shuffle_plain(torch.from_numpy(syms), torch.from_numpy(state0)).numpy(),
    )


def test_shuffle_debug_checks():
    syms, state0 = _shuffle_case(C=3)
    t_syms, t_state = torch.from_numpy(syms), torch.from_numpy(state0)
    np.testing.assert_array_equal(
        mtf_shuffle(t_syms, t_state, debug_checks=True).numpy(),
        mtf_shuffle(t_syms, t_state).numpy(),
    )
    bad = t_state.clone()
    bad[0, 1] = bad[0, 0]          # duplicate entry: not a permutation
    dup_syms = torch.full((3, 8), int(bad[0, 0]), dtype=torch.int32)
    with pytest.raises(AssertionError, match="invariant"):
        mtf_shuffle(dup_syms, bad, debug_checks=True)


def test_shuffle_rejects_bad_shapes():
    with pytest.raises(ValueError):
        mtf_shuffle(torch.zeros((2, 8), dtype=torch.int32),
                    torch.zeros((3, 256), dtype=torch.int32))
    with pytest.raises(TypeError):
        mtf_shuffle(torch.zeros((2, 8), dtype=torch.int64),
                    torch.zeros((2, 256), dtype=torch.int64))


@pytest.mark.parametrize("seed,N,n,alpha", [
    (10, 4160, 4000, 256),     # N a multiple of 64, not of 256 or more
    (11, 5000, 4999, 7),       # N a multiple of none of the chunks
    (12, 3000, 1, 1),
])
def test_mtf_indices_same_at_every_chunk(seed, N, n, alpha):
    """The output does not depend on the chunk: 64 (the JAX pipeline's),
    256, 1024 and 2048, with the symbols padded to a chunk multiple
    inside ``mtf_indices``; and it equals the JAX package's
    ``mtf_indices_device`` and the host twin."""
    rng = np.random.default_rng(seed)
    blocks = np.zeros((2, N), np.uint8)
    ns = [n, max(1, n // 3)]
    present = np.zeros((2, 256), bool)
    for b, nb in enumerate(ns):
        blocks[b, :nb] = rng.integers(0, alpha, nb)
        present[b, blocks[b, :nb]] = True
    args = (torch.from_numpy(blocks), torch.tensor(ns),
            torch.from_numpy(present))
    outs = {k: mtf_indices(*args, k).numpy() for k in (64, 256, 1024, 2048)}
    for k, got in outs.items():
        assert got.shape == (2, N) and got.dtype == np.int32, k
        np.testing.assert_array_equal(got, outs[64])
    Np = -(-N // 64) * 64
    f = partial(mtf_indices_device, chunk=64)
    for b, nb in enumerate(ns):
        row = np.zeros(Np, np.uint8)
        row[:N] = blocks[b]
        want = np.asarray(f(jnp.asarray(row), jnp.int32(nb),
                            jnp.asarray(present[b])))
        np.testing.assert_array_equal(outs[64][b, :nb], want[:nb])
        np.testing.assert_array_equal(
            outs[64][b, :nb], host_mtf(blocks[b, :nb], present[b]))
        assert (outs[64][b, nb:] == -1).all()


def test_mtf_indices_main_path_chunk_matches_cpu_default():
    """The card's chunk ``CHUNK`` (one of 64..2048) gives the output of
    the CPU's default chunk."""
    from banzai_tpu_torch.ops.mtf import CHUNK, CPU_CHUNK

    assert 64 <= CHUNK <= 2048 and CHUNK & (CHUNK - 1) == 0
    rng = np.random.default_rng(13)
    n = CHUNK + 300
    block = rng.integers(0, 40, (1, n + 17)).astype(np.uint8)
    present = np.zeros((1, 256), bool)
    present[0, block[0, :n]] = True
    args = (torch.from_numpy(block), torch.tensor([n]),
            torch.from_numpy(present))
    assert CPU_CHUNK == 64
    np.testing.assert_array_equal(mtf_indices(*args).numpy(),
                                  mtf_indices(*args, CHUNK).numpy())


def test_shuffle_plain_matches_pallas_interpret_long_chunk():
    """K = 1024, a long chunk of the kind the card's kernel runs: the
    plain version equals the Pallas kernel in interpret mode, exactly."""
    syms, state0 = _shuffle_case(C=8, K=1024, seed=9)
    got = mtf_shuffle_plain(torch.from_numpy(syms), torch.from_numpy(state0))
    want = mtf_shuffle_pallas(
        jnp.asarray(syms), jnp.asarray(state0), interpret=True
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_shuffle_debug_flags_state_outside_bytes():
    syms, state0 = _shuffle_case(C=2, K=16)
    bad = torch.from_numpy(state0).clone()
    bad[1, 7] = 300
    with pytest.raises(AssertionError, match="bit 2"):
        mtf_shuffle(torch.from_numpy(syms), bad, debug_checks=True)
