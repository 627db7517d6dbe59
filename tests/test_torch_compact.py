"""Kernel K4 (stream compaction): the port's compact_stream against the
JAX package's Pallas kernel in interpret mode, with exact equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from banzai_tpu.ops.compact_pallas import compact_stream as jax_compact_stream
from banzai_tpu_torch.ops.compact_kernel import (
    compact_stream, compact_stream_plain,
)


@pytest.mark.parametrize("seed,n,density", [
    (0, 2048, 0.5),
    (1, 4096, 0.05),
    (2, 4096, 0.95),
    (3, 512, 0.0),
    (4, 512, 1.0),
])
def test_compact_stream_matches_jax(seed, n, density):
    rng = np.random.default_rng(seed)
    mask = rng.random(n) < density
    pay = rng.integers(0, 1 << 30, n).astype(np.int32)
    want, want_count = jax_compact_stream(
        jnp.asarray(mask), jnp.asarray(pay), tile=512, interpret=True
    )
    count = int(want_count)
    packed, got_count = compact_stream(
        torch.from_numpy(mask), torch.from_numpy(pay), tile=512
    )
    assert packed.dtype == torch.int32 and packed.shape == (n,)
    assert int(got_count) == count == int(mask.sum())
    np.testing.assert_array_equal(
        packed.numpy()[:count], np.asarray(want)[:count]
    )
    assert not packed[count:].any()


def test_compact_stream_int_mask_and_plain_agree():
    rng = np.random.default_rng(7)
    idx = torch.from_numpy(rng.integers(0, 4, 1024).astype(np.int32))
    packed, count = compact_stream(idx, idx)
    want, want_count = compact_stream_plain(idx != 0, idx)
    assert torch.equal(packed, want) and int(count) == int(want_count)
    assert torch.equal(packed[: int(count)], idx[idx != 0])


@pytest.mark.parametrize("n,tile", [(1000, 512), (512, 0), (100, 64)])
def test_compact_stream_length_not_a_tile_multiple_raises(n, tile):
    mask = torch.ones(n, dtype=torch.bool)
    with pytest.raises(ValueError, match="multiple"):
        compact_stream(mask, torch.zeros(n, dtype=torch.int32), tile=tile)


def test_build_waits_for_every_compile_and_reports_the_failure(tmp_path):
    """The kernel build runs one compiler per source side by side; a
    failure is raised with its stderr only after every process ended."""
    import sys

    from banzai_tpu_torch import _build

    done = tmp_path / "done"
    slow_ok = [sys.executable, "-c",
               f"import time; time.sleep(0.5); open({str(done)!r}, 'w')"]
    fails = [sys.executable, "-c",
             "import sys; sys.stderr.write('boom'); sys.exit(3)"]
    with pytest.raises(RuntimeError, match="(?s)failed \\(3\\).*\\nboom$"):
        _build._run_all([fails, slow_ok])
    assert done.exists()
    _build._run_all([slow_ok])
