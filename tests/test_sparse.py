"""SpMM primitives and B-matrix construction vs dense numpy."""

import numpy as np
import pytest

from isle_jax.bmatrix import threshold_and_copy, threshold_and_copy_np
from isle_jax.corpus import Corpus
from isle_jax.sparse import DocSparse, b_y, bt_x, doc_l2sq, gram_x, to_dense


def random_sparse(rng, V, D, density=0.1, chunk=256):
    mask = rng.random((V, D)) < density
    w, d = np.nonzero(mask)
    order = np.lexsort((w, d))
    w, d = w[order], d[order]
    v = rng.random(len(w)).astype(np.float32) * 5 + 0.5
    return DocSparse.build(w, d, v, V, D, chunk=chunk), w, d, v


@pytest.mark.parametrize("seed", [0, 1])
def test_spmm_both_directions(seed):
    rng = np.random.default_rng(seed)
    V, D, c = 67, 43, 8
    sp, w, d, v = random_sparse(rng, V, D)
    Bd = np.zeros((V, D), np.float32)
    Bd[w, d] = v
    X = rng.standard_normal((V, c)).astype(np.float32)
    Y = rng.standard_normal((D, c)).astype(np.float32)
    np.testing.assert_allclose(np.asarray(bt_x(sp, X)), Bd.T @ X, rtol=2e-5, atol=1e-4)
    np.testing.assert_allclose(np.asarray(b_y(sp, Y)), Bd @ Y, rtol=2e-5, atol=1e-4)
    np.testing.assert_allclose(
        np.asarray(gram_x(sp, X)), Bd @ (Bd.T @ X), rtol=2e-4, atol=1e-3
    )
    np.testing.assert_allclose(
        np.asarray(doc_l2sq(sp)), (Bd * Bd).sum(axis=0), rtol=2e-5, atol=1e-4
    )
    np.testing.assert_allclose(to_dense(sp), Bd, rtol=0, atol=0)


def test_spmm_multichunk():
    rng = np.random.default_rng(3)
    V, D, c = 30, 40, 4
    sp, w, d, v = random_sparse(rng, V, D, density=0.5, chunk=64)
    assert sp.padded_nnz > 64
    Bd = np.zeros((V, D), np.float32)
    Bd[w, d] = v
    X = rng.standard_normal((V, c)).astype(np.float32)
    np.testing.assert_allclose(np.asarray(bt_x(sp, X, chunk=64)), Bd.T @ X, rtol=2e-5, atol=1e-4)


def test_threshold_and_copy_matches_np():
    rng = np.random.default_rng(5)
    V, D = 23, 31
    sp, w, d, v = random_sparse(rng, V, D, density=0.3, chunk=128)
    zetas = rng.integers(1, 5, V).astype(np.float32)
    B, original_cols = threshold_and_copy(sp, zetas, chunk=128)
    kw, kd, kv, oc_ref = threshold_and_copy_np(w, d, v, zetas, D)
    np.testing.assert_array_equal(original_cols, oc_ref)
    assert B.nnz == len(kw)
    assert B.num_docs == len(oc_ref)
    np.testing.assert_array_equal(np.asarray(B.d_word)[: B.nnz], kw)
    np.testing.assert_array_equal(np.asarray(B.d_doc)[: B.nnz], kd)
    np.testing.assert_allclose(np.asarray(B.d_val)[: B.nnz], kv, rtol=1e-6)
    # padding is sentinel
    np.testing.assert_array_equal(np.asarray(B.d_word)[B.nnz :], V)
    # word-sorted copy is consistent: same dense matrix
    dense_from_w = np.zeros((V + 1, B.num_docs + 1), np.float32)
    np.add.at(
        dense_from_w,
        (np.asarray(B.w_word), np.asarray(B.w_doc)),
        np.asarray(B.w_val),
    )
    np.testing.assert_allclose(
        dense_from_w[:V, : B.num_docs], to_dense(B), atol=1e-6
    )
    ww = np.asarray(B.w_word)[: B.nnz]
    assert (np.diff(ww) >= 0).all()


def test_sampled_threshold_and_copy():
    import jax

    rng = np.random.default_rng(9)
    V, D = 15, 200
    sp, w, d, v = random_sparse(rng, V, D, density=0.2, chunk=512)
    zetas = np.ones(V, np.float32)
    B, oc = threshold_and_copy(
        sp, zetas, sample_rate=0.25, key=jax.random.PRNGKey(0), chunk=512
    )
    # roughly a quarter of docs survive (ties can add a few)
    assert 0.15 * D <= B.num_docs <= 0.45 * D
    assert B.nnz < sp.nnz
    assert (np.diff(oc) > 0).all()


def test_from_corpus_nondefault_normalization_falls_back():
    """The compact device rebuild recomputes vals as avg*(count/doc_sum);
    corpora normalized any other way (int_normalized, normalize_to_one)
    must fall back to the full upload and reproduce corpus.vals exactly
    (round-4 review, confirmed: int-normalized training silently used
    non-ceil values)."""
    rng = np.random.default_rng(0)
    d = np.repeat(np.arange(20), 5)
    w = np.tile(np.arange(5) * 3, 20)
    c = rng.integers(1, 9, 100)
    for kw in (dict(int_normalized=True), dict(normalize_to_one=True), {}):
        corpus = Corpus.from_entries(
            d, w, c, vocab_size=16, num_docs=20, **kw
        )
        sp = DocSparse.from_corpus(corpus, chunk=512)
        dense = np.asarray(to_dense(sp))
        ref = np.zeros((16, 20), np.float32)
        n = corpus.nnz
        ref[corpus.rows[:n], corpus.doc_ids()[:n]] = corpus.vals[:n]
        np.testing.assert_array_equal(dense, ref, err_msg=str(kw))
