"""The port's copies of the host modules against the JAX package's
originals, on the CPU: the same seeded inputs through both, byte-identical
outputs.  The copies (``banzai_tpu_torch.{crc32,rle1,huffman_host,
encoder_host,oracle,native}``) exist so the port imports nothing of
``banzai_tpu``; only their imports differ."""

import numpy as np
import pytest

from banzai_tpu import crc32 as j_crc32
from banzai_tpu import encoder_host as j_host
from banzai_tpu import huffman_host as j_huff
from banzai_tpu import mtf_rle2 as j_mtf
from banzai_tpu import native as j_native
from banzai_tpu import rle1 as j_rle1
from banzai_tpu.oracle import banzai_compress as j_banzai
from banzai_tpu.oracle.stages import numpy_bwt as j_numpy_bwt
from banzai_tpu_torch import crc32 as t_crc32
from banzai_tpu_torch import encoder_host as t_host
from banzai_tpu_torch import huffman_host as t_huff
from banzai_tpu_torch import mtf_rle2 as t_mtf
from banzai_tpu_torch import native as t_native
from banzai_tpu_torch import rle1 as t_rle1
from banzai_tpu_torch.oracle import banzai_compress as t_banzai
from banzai_tpu_torch.oracle.stages import numpy_bwt as t_numpy_bwt


def _inputs() -> dict[str, bytes]:
    rng = np.random.default_rng(11)
    walk = (np.cumsum(rng.integers(-2, 3, 60_000)) & 0xFF).astype(np.uint8)
    return {
        "empty": b"",
        "run4": b"a" * 4,
        "run255": b"b" * 255,
        "run256": b"c" * 256,
        "run259": b"d" * 259,
        "run260": b"e" * 260,
        "abc": b"abc" * 100_000,
        "random": rng.integers(0, 256, 150_000, dtype=np.uint8).tobytes(),
        "walk": walk.tobytes(),
    }


INPUTS = _inputs()
SMALL = ["empty", "run4", "run255", "run256", "run259", "run260", "walk"]


def _blocks(mod, data, level, native):
    return [(bytes(b.output), b.consumed, b.crc)
            for b in mod.iter_blocks(data, level, native=native)]


@pytest.mark.parametrize("native", [None, False], ids=["native", "numpy"])
@pytest.mark.parametrize("level", [1, 9])
@pytest.mark.parametrize("name", sorted(INPUTS))
def test_iter_blocks_match(name, level, native):
    data = INPUTS[name]
    got = _blocks(t_rle1, data, level, native)
    assert got == _blocks(j_rle1, data, level, native)
    if native is None:
        # The copy's native and NumPy paths agree with each other too.
        assert got == _blocks(t_rle1, data, level, False)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_crc32_match(seed):
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, int(rng.integers(0, 5000)),
                        dtype=np.uint8).tobytes()
    assert t_crc32.block_crc(data) == j_crc32.block_crc(data)
    assert t_crc32.block_crc_slow(data) == t_crc32.block_crc(data)
    s = int(rng.integers(0, 1 << 32))
    assert (t_crc32.combine_stream_crc(s, t_crc32.block_crc(data))
            == j_crc32.combine_stream_crc(s, j_crc32.block_crc(data)))


def _first_block(name, level=1):
    return next(t_rle1.iter_blocks(INPUTS[name], level)).output


@pytest.mark.parametrize("name", ["abc", "random", "walk", "run260"])
def test_plan_and_write_entropy_match(name):
    ptr, present, syms, _plan = t_host.block_plan(_first_block(name))
    num_syms = int(present.sum()) + 2
    freqs = np.bincount(syms, minlength=num_syms)
    got = t_huff.plan_entropy(syms, num_syms, freqs)
    want = j_huff.plan_entropy(syms, num_syms, freqs)
    assert got.num_tables == want.num_tables
    np.testing.assert_array_equal(got.tables, want.tables)
    np.testing.assert_array_equal(got.selectors, want.selectors)
    bw_t, bw_j = t_host.BitWriter(), j_host.BitWriter()
    t_huff.write_entropy(bw_t, syms, got)
    j_huff.write_entropy(bw_j, syms, want)
    assert bw_t.bit_length == bw_j.bit_length
    assert bw_t.close() == bw_j.close()


@pytest.mark.parametrize("level", [1, 9])
@pytest.mark.parametrize("name", sorted(INPUTS))
def test_encoder_host_compress_match(name, level):
    data = INPUTS[name]
    got = t_host.compress(data, level, jobs=1)
    assert got == j_host.compress(data, level, jobs=1)


@pytest.mark.parametrize("level", [1, 9])
@pytest.mark.parametrize("name", SMALL)
def test_banzai_oracle_match(name, level):
    data = INPUTS[name]
    assert t_banzai(data, level) == j_banzai(data, level)


@pytest.mark.parametrize("name", ["abc", "random", "walk", "run256"])
def test_native_and_numpy_paths_match(name):
    """The copy's native C paths equal its NumPy paths and the
    original's native paths."""
    out = _first_block(name)
    bwt, ptr = t_native.host_bwt_native(out)
    want_bwt, want_ptr = t_numpy_bwt(out)
    np.testing.assert_array_equal(bwt, want_bwt)
    assert ptr == want_ptr
    j_bwt, j_ptr = j_native.host_bwt_native(out)
    np.testing.assert_array_equal(bwt, j_bwt)
    assert ptr == j_ptr
    np.testing.assert_array_equal(*map(np.asarray, (want_bwt,
                                                    j_numpy_bwt(out)[0])))

    present = np.zeros(256, bool)
    present[out] = True
    idx = t_native.mtf_native(bwt, present)
    np.testing.assert_array_equal(idx, t_mtf.mtf_indices(bwt, present))
    np.testing.assert_array_equal(idx, j_mtf.mtf_indices(bwt, present))

    rng = np.random.default_rng(len(out))
    for nt in (2, 3, 6):
        sel = rng.integers(0, nt, 300).astype(np.uint8)
        got = t_native.selector_mtf_native(sel, nt)
        np.testing.assert_array_equal(
            got, list(t_huff.iter_selector_mtf(sel, nt)))
        np.testing.assert_array_equal(got, j_native.selector_mtf_native(sel, nt))


def test_native_builds_inside_the_package():
    """The copy builds its C sources into the package's ignored
    ``_build/``, not into a per-user cache."""
    import os

    assert t_native.get_rle1() is not None and t_native.get_sais() is not None
    build = os.path.join(os.path.dirname(os.path.dirname(t_native.__file__)),
                         "_build")
    assert t_native._CACHE == build
    names = os.listdir(build)
    assert any(n.startswith("rle1-") and n.endswith(".so") for n in names)
    assert any(n.startswith("sais-") and n.endswith(".so") for n in names)
