"""Topic-model construction and edge topics vs the literal restatement."""

import jax.numpy as jnp
import numpy as np
import pytest

from isle_jax.config import HyperParams
from isle_jax.sparse import DocSparse
from isle_jax.topic_model import (
    construct_edge_topics_v2,
    construct_topic_model,
    doc_topic_mass,
    top_two_topics,
)
from literal_oracle import construct_topic_model_literal

pytestmark = pytest.mark.quick  # <60s smoke tier


def make_case(rng, V, D, k, density=0.3):
    mask = rng.random((V, D)) < density
    w, d = np.nonzero(mask)
    order = np.lexsort((w, d))
    w, d = w[order], d[order]
    v = (rng.random(len(w)) * 4 + 0.5).astype(np.float32)
    offsets = np.zeros(D + 1, np.int64)
    np.add.at(offsets, d + 1, 1)
    offsets = np.cumsum(offsets)
    sp = DocSparse.build(w, d, v, V, D, chunk=2048)
    # random disjoint catchwords
    cw_topic = np.full(V, -1, np.int32)
    perm = rng.permutation(V)[: k * 3]
    for i, word in enumerate(perm):
        cw_topic[word] = i % k
    cluster = rng.integers(0, k, D).astype(np.int32)
    catchwords = [list(np.flatnonzero(cw_topic == t)) for t in range(k)]
    closest = [list(np.flatnonzero(cluster == t)) for t in range(k)]
    return sp, w, d, v, offsets, cw_topic, cluster, catchwords, closest


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_model_matches_literal(seed):
    rng = np.random.default_rng(seed)
    V, D, k = 25, 50, 4
    sp, w, d, v, offsets, cw_topic, cluster, catchwords, closest = make_case(
        rng, V, D, k
    )
    hp = HyperParams()
    rank_threshold = hp.model_rank_threshold(D, k)
    model, pairs = construct_topic_model(
        sp,
        jnp.asarray(cw_topic),
        jnp.asarray(cluster),
        k,
        rank_threshold,
        want_top_pairs=True,
    )
    ref_model, ref_pairs = construct_topic_model_literal(
        offsets, w, v, V, D, k, closest, catchwords, hp.eps3, hp.w0, True
    )
    np.testing.assert_allclose(np.asarray(model), ref_model, rtol=2e-4, atol=1e-6)
    t1, t2, valid = (np.asarray(x) for x in pairs)
    got_pairs = [
        (int(t1[i]), int(t2[i]), i) for i in np.flatnonzero(valid)
    ]
    assert got_pairs == ref_pairs


def test_doc_topic_mass_simple():
    V, D, k = 4, 3, 2
    w = np.array([0, 1, 2, 0, 3])
    d = np.array([0, 0, 1, 2, 2])
    v = np.array([1.0, 2.0, 3.0, 4.0, 5.0], np.float32)
    sp = DocSparse.build(w, d, v, V, D, chunk=64)
    cw = np.array([0, 1, -1, 1], np.int32)  # word0 -> t0, word1/3 -> t1
    mass = np.asarray(doc_topic_mass(sp, jnp.asarray(cw), k))
    np.testing.assert_allclose(mass, [[1, 2], [0, 0], [4, 5]])


def test_top_two_tie_semantics():
    mass = jnp.asarray(
        np.array([[5.0, 5.0, 1.0], [0.0, 0.0, 0.0], [3.0, 0.0, 0.0]], np.float32)
    )
    t1, t2, valid = (np.asarray(x) for x in top_two_topics(mass))
    assert t1[0] == 0 and t2[0] == 1 and valid[0]
    assert not valid[1]  # all-zero mass: no pair
    assert not valid[2]  # single positive topic: no pair


def test_edge_topics_v2():
    k = 4
    model = np.eye(5, k, dtype=np.float32)
    t1 = np.array([0, 0, 0, 1, 2, 2], np.int32)
    t2 = np.array([1, 1, 2, 0, 3, 3], np.int32)
    valid = np.array([True, True, True, True, True, False])
    edge, sel = construct_edge_topics_v2(t1, t2, valid, model, k, max_edge_topics=2)
    # counts: (0,1)=2, (0,2)=1, (1,0)=1, (2,3)=1 -> top2 = (0,1) then (0,2)
    np.testing.assert_array_equal(sel[:, :2], [[0, 1], [0, 2]])
    np.testing.assert_array_equal(sel[:, 2], [2, 1])
    np.testing.assert_allclose(edge[:, 0], 0.7 * model[:, 0] + 0.3 * model[:, 1])
    assert edge.shape == (5, 2)
