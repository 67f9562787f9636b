"""Catchword statistics vs the literal reference restatement."""

import numpy as np
import pytest

from isle_jax.catchwords import catchword_topic_map, find_catchwords, rth_highest
from isle_jax.sparse import DocSparse
from literal_oracle import find_catchwords_literal, rth_highest_literal

pytestmark = pytest.mark.quick  # <60s smoke tier


def make_corpus(rng, V, D, density):
    mask = rng.random((V, D)) < density
    w, d = np.nonzero(mask)
    order = np.lexsort((w, d))
    w, d = w[order], d[order]
    v = (rng.random(len(w)) * 9 + 0.5).astype(np.float32)
    offsets = np.zeros(D + 1, np.int64)
    np.add.at(offsets, d + 1, 1)
    offsets = np.cumsum(offsets)
    return w, d, v, offsets


@pytest.mark.parametrize("seed,r", [(0, 1), (1, 2), (2, 5), (3, 9)])
def test_rth_highest_matches_literal(seed, r):
    rng = np.random.default_rng(seed)
    V, D, k = 19, 60, 4
    w, d, v, offsets = make_corpus(rng, V, D, 0.3)
    sp = DocSparse.build(w, d, v, V, D, chunk=1024)
    cluster = rng.integers(-1, k, D).astype(np.int32)  # some docs unassigned
    sizes = np.bincount(cluster[cluster >= 0], minlength=k).astype(np.int32)

    thr = np.asarray(rth_highest(sp, cluster, sizes, k, r))
    for t in range(k):
        part = np.flatnonzero(cluster == t)
        ref = rth_highest_literal(offsets, w, v, V, r, part)
        np.testing.assert_allclose(thr[t], ref, rtol=1e-6, atol=1e-7)


def test_rth_highest_degenerate_min_case():
    # r >= cluster size and word present in every doc of the cluster -> min
    V, D, k = 3, 4, 2
    w = np.array([0, 1, 0, 0, 2], dtype=np.int64)
    d = np.array([0, 0, 1, 2, 3], dtype=np.int64)
    v = np.array([5.0, 2.0, 3.0, 4.0, 1.0], dtype=np.float32)
    sp = DocSparse.build(w, d, v, V, D, chunk=64)
    cluster = np.array([0, 0, 0, 1], np.int32)
    sizes = np.array([3, 1], np.int32)
    thr = np.asarray(rth_highest(sp, cluster, sizes, k, r=3))
    # word 0 occurs in all 3 docs of cluster 0, r=3 == size -> min = 3.0
    assert thr[0, 0] == 3.0
    # word 1 occurs once -> 0
    assert thr[0, 1] == 0.0
    # cluster 1 size 1, word 2 occurs in its only doc, r >= 1 -> min = 1.0
    assert thr[1, 2] == 1.0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_find_catchwords_matches_literal(seed):
    rng = np.random.default_rng(seed)
    k, V = 5, 40
    thr = rng.random((k, V)).astype(np.float32)
    thr[thr < 0.3] = 0.0  # plenty of zeros
    thr[:, 0] = 0.0  # all-zero word: no catchword
    thr[0, 1] = thr[1, 1] = 0.5  # exact tie
    got = np.asarray(find_catchwords(thr, 1.1))
    ref = find_catchwords_literal(thr, 1.1)
    for t in range(k):
        np.testing.assert_array_equal(np.flatnonzero(got[t]), ref[t])
    cwt = catchword_topic_map(got)
    for t in range(k):
        assert set(np.flatnonzero(cwt == t)) == set(ref[t])


def test_single_topic_no_catchwords():
    thr = np.array([[1.0, 2.0, 3.0]], np.float32)
    got = np.asarray(find_catchwords(thr, 1.1))
    assert not got.any()
