"""The traffic: generators, the pool and the job sequence."""

from __future__ import annotations

import bz2

import numpy as np
import pytest

from benchmark import pool

TRAFFIC = ["silesia-mix"]


def small(name: str) -> dict:
    t = pool.load_traffic(name)
    t["pool_bytes"] = 1 << 20
    return t


@pytest.mark.parametrize("name", TRAFFIC)
def test_pool_is_fixed_by_the_seed(name):
    t = small(name)
    a, b = pool.build_pool(t, 2**31 + 7), pool.build_pool(t, 2**31 + 7)
    c = pool.build_pool(t, 2**31 + 8)
    assert a == b
    assert a != c


@pytest.mark.parametrize("name", TRAFFIC)
def test_pool_keeps_the_category_shares(name):
    t = small(name)
    parts = pool.build_pool(t, 3)
    total = sum(map(len, parts))
    assert total == t["pool_bytes"]
    for cat, part in zip(t["categories"], parts):
        assert abs(len(part) / total - cat["share"]) < 1e-5


@pytest.mark.parametrize("name", [c["generator"] for c in pool.load_traffic("silesia-mix")["categories"]])
def test_generator_is_deterministic_and_sized(name):
    cats = pool.load_traffic("silesia-mix")["categories"]
    params = next(c["params"] for c in cats if c["generator"] == name)
    gen = pool.generator(name)
    a = gen.generate(np.random.default_rng(11), 200_000, params)
    assert a == gen.generate(np.random.default_rng(11), 200_000, params)
    assert a != gen.generate(np.random.default_rng(12), 200_000, params)
    assert len(a) == 200_000
    # Compressible, as every category of the corpus is, and not trivially.
    ratio = len(bz2.compress(a, 9)) / len(a)
    assert 0.02 < ratio < 0.75


@pytest.mark.parametrize("name", TRAFFIC)
def test_job_sizes_are_fixed_by_the_seed_and_the_same_set_each_round(name):
    t = pool.load_traffic(name)
    classes = pool.size_classes(t)
    k = len(classes)
    assert classes.min() >= t["job_bytes"]["min"] and classes.max() <= t["job_bytes"]["max"]
    # Log-spaced: equal ratios between neighbours.
    r = classes[1:] / classes[:-1]
    assert np.allclose(r, r[0], rtol=1e-5)
    take = lambda s: [j for j, _ in zip(pool.jobs(t, s), range(5 * k))]  # noqa: E731
    a, b, c = take(2**31 + 1), take(2**31 + 1), take(2**31 + 2)
    assert a == b
    assert [j.size for j in a] != [j.size for j in c]
    for jobs in (a, c):
        for r0 in range(0, 5 * k, k):
            assert sorted(j.size for j in jobs[r0 : r0 + k]) == sorted(classes.tolist())


@pytest.mark.parametrize("name", TRAFFIC)
def test_each_job_holds_every_category_in_its_share(name):
    t = small(name)
    parts = pool.build_pool(t, 5)
    t["job_bytes"] = {"min": 65536, "max": 262144, "classes": 4}
    for job, _ in zip(pool.jobs(t, 5), range(12)):
        data = job.data(parts)
        assert len(data) == job.size
        got = {c: n for c, _o, n in job.pieces}
        for c, cat in enumerate(t["categories"]):
            assert abs(got.get(c, 0) - cat["share"] * job.size) <= len(t["categories"])
        for c, o, n in job.pieces:
            assert 0 <= o and o + n <= len(parts[c])
