"""Parallel-primitives tests: scan / compact / radix sort vs NumPy semantics.

Mirrors the reference's stream_compaction test intent (the library the README
commits to swapping in, SURVEY.md §2.5); here it gets the real unit tests the
reference lacks.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from pathtracer_tpu.ops.scan import (compact, compaction_indices,
                                     exclusive_scan, gather_tree, sort_by_key)


@pytest.mark.parametrize("n", [1, 7, 128, 4096, 4097, 40000])
def test_exclusive_scan_int(n):
    rng = np.random.default_rng(n)
    x = rng.integers(0, 5, size=n).astype(np.int32)
    got = np.asarray(exclusive_scan(jnp.asarray(x)))
    want = np.cumsum(x) - x
    np.testing.assert_array_equal(got, want)


def test_exclusive_scan_float():
    rng = np.random.default_rng(0)
    x = rng.standard_normal(20000).astype(np.float32)
    got = np.asarray(exclusive_scan(jnp.asarray(x)))
    want = (np.cumsum(x) - x).astype(np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("n", [16, 4096, 10000])
def test_compact_stable_partition(n):
    rng = np.random.default_rng(n * 7 + 1)
    mask = rng.random(n) < 0.3
    vals = np.arange(n, dtype=np.int32) * 10
    tree = {"v": jnp.asarray(vals), "w": jnp.asarray(vals.astype(np.float32))}
    packed, count = compact(tree, jnp.asarray(mask))
    count = int(count)
    assert count == mask.sum()
    # live elements packed to the front, stable order
    np.testing.assert_array_equal(np.asarray(packed["v"])[:count],
                                  vals[mask])
    # dead elements preserved at the back, stable order
    np.testing.assert_array_equal(np.asarray(packed["v"])[count:],
                                  vals[~mask])
    np.testing.assert_array_equal(np.asarray(packed["w"]),
                                  np.asarray(packed["v"]).astype(np.float32))


def test_compact_all_and_none():
    vals = jnp.arange(100, dtype=jnp.int32)
    packed, count = compact({"v": vals}, jnp.ones(100, bool))
    assert int(count) == 100
    np.testing.assert_array_equal(np.asarray(packed["v"]), np.arange(100))
    packed, count = compact({"v": vals}, jnp.zeros(100, bool))
    assert int(count) == 0
    np.testing.assert_array_equal(np.asarray(packed["v"]), np.arange(100))


def test_compaction_indices_is_permutation():
    rng = np.random.default_rng(3)
    mask = jnp.asarray(rng.random(5000) < 0.5)
    idx, _ = compaction_indices(mask)
    assert sorted(np.asarray(idx).tolist()) == list(range(5000))


@pytest.mark.parametrize("n", [8, 1000, 12345])
def test_radix_sort_stable(n):
    rng = np.random.default_rng(n)
    keys = rng.integers(0, 17, size=n).astype(np.int32)
    payload = np.arange(n, dtype=np.int32)
    skeys, stree = sort_by_key(jnp.asarray(keys), {"p": jnp.asarray(payload)},
                               n_bits=5)
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(np.asarray(skeys), keys[order])
    np.testing.assert_array_equal(np.asarray(stree["p"]), payload[order])


def test_gather_tree():
    tree = {"a": jnp.arange(4), "b": jnp.arange(4) * 2.0}
    out = gather_tree(tree, jnp.asarray([3, 2, 1, 0]))
    np.testing.assert_array_equal(np.asarray(out["a"]), [3, 2, 1, 0])
    np.testing.assert_array_equal(np.asarray(out["b"]), [6.0, 4.0, 2.0, 0.0])


@pytest.mark.parametrize("n", [64, 5000])
def test_partition_multisort(n):
    from pathtracer_tpu.ops.scan import partition_multisort

    rng = np.random.default_rng(n)
    mask = rng.random(n) < 0.4
    vals = np.arange(n, dtype=np.int32)
    packed, count = partition_multisort({"v": jnp.asarray(vals)},
                                        jnp.asarray(mask))
    count = int(count)
    assert count == mask.sum()
    np.testing.assert_array_equal(np.asarray(packed["v"])[:count], vals[mask])
    np.testing.assert_array_equal(np.asarray(packed["v"])[count:], vals[~mask])


def test_sort_by_key_multisort_matches_radix():
    from pathtracer_tpu.ops.scan import sort_by_key_multisort

    rng = np.random.default_rng(11)
    keys = rng.integers(0, 9, size=3000).astype(np.int32)
    payload = np.arange(3000, dtype=np.int32)
    k1, t1 = sort_by_key(jnp.asarray(keys), {"p": jnp.asarray(payload)},
                         n_bits=4)
    k2, t2 = sort_by_key_multisort(jnp.asarray(keys),
                                   {"p": jnp.asarray(payload)})
    np.testing.assert_array_equal(np.asarray(k1), np.asarray(k2))
    np.testing.assert_array_equal(np.asarray(t1["p"]), np.asarray(t2["p"]))
