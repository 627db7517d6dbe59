"""banzai_tpu_torch BWT vs the JAX package's bwt_rotations and the NumPy
oracle, on the CPU.  Exact equality: the BWT column and ptr are integers."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from banzai_tpu.ops.bwt import bwt_rotations as jax_bwt
from banzai_tpu.oracle.stages import numpy_bwt
from banzai_tpu_torch.ops.bwt import bwt_rotations

N = 8192


def _case(kind: str) -> np.ndarray:
    rng = np.random.default_rng(sum(kind.encode()))
    if kind.startswith("random"):
        n = int(kind.split("_")[1])
        return rng.integers(0, 256, n).astype(np.uint8)
    if kind == "period5":
        return np.frombuffer(b"abcde" * 1000, np.uint8)
    if kind == "alpha4":
        return rng.integers(0, 4, 5000).astype(np.uint8)
    if kind == "zeros":
        return np.zeros(4000, np.uint8)
    raise ValueError(kind)


CASES = ["random_1", "random_6", "random_500", "random_5000",
         "period5", "alpha4", "zeros"]


def _padded(arr: np.ndarray) -> np.ndarray:
    block = np.zeros(N, np.uint8)
    block[: len(arr)] = arr
    return block


@pytest.mark.parametrize("kind", CASES)
def test_bwt_matches_jax_and_oracle(kind):
    arr = _case(kind)
    n = len(arr)
    block = _padded(arr)
    bwt_t, ptr_t = bwt_rotations(
        torch.from_numpy(block)[None], torch.tensor([n])
    )
    bwt_j, ptr_j = jax_bwt(jnp.asarray(block), jnp.int32(n))
    bwt_o, ptr_o = numpy_bwt(arr)
    got = bwt_t[0, :n].numpy()
    np.testing.assert_array_equal(got, np.asarray(bwt_j)[:n])
    np.testing.assert_array_equal(got, bwt_o)
    assert int(ptr_t[0]) == int(ptr_j) == ptr_o


def test_bwt_batched_rows_match_single_rows():
    """All cases in one batch: rows do not interact, and padded lanes of
    short rows rank after every real rotation."""
    arrs = [_case(k) for k in CASES]
    blocks = np.stack([_padded(a) for a in arrs])
    ns = torch.tensor([len(a) for a in arrs])
    bwt_b, ptr_b = bwt_rotations(torch.from_numpy(blocks), ns)
    for i, a in enumerate(arrs):
        bwt_o, ptr_o = numpy_bwt(a)
        np.testing.assert_array_equal(bwt_b[i, : len(a)].numpy(), bwt_o)
        assert int(ptr_b[i]) == ptr_o
