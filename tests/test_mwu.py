"""Batched MWU inference vs the literal per-doc restatement."""

import numpy as np
import pytest

from isle_jax.corpus import Corpus
from isle_jax.mwu import build_infer_batch, infer_all
from literal_oracle import mwu_literal


def make_model(rng, V, k):
    M = rng.random((V, k)).astype(np.float32)
    M[M < 0.5] = 0.0
    M[0] = 0.0  # a word with zero model mass everywhere (dropped in slices)
    M /= np.maximum(M.sum(axis=0, keepdims=True), 1e-9)
    return M


@pytest.mark.parametrize("seed", [0, 1])
def test_matches_literal(seed):
    rng = np.random.default_rng(seed)
    V, D, k = 30, 25, 6
    M = make_model(rng, V, k)
    docs, words, counts = [], [], []
    for d in range(D):
        ws = rng.choice(V, size=rng.integers(2, 10), replace=False)
        for w in np.sort(ws):
            docs.append(d)
            words.append(w)
            counts.append(int(rng.integers(1, 7)))
    corpus = Corpus.from_entries(
        np.array(docs), np.array(words), np.array(counts),
        vocab_size=V, num_docs=D, normalize_to_one=True,
    )
    batch = build_infer_batch(corpus, M.sum(axis=1))
    weights, conv, llh_doc, llh_w = infer_all(M, batch, iters=15, Lf=10.0)

    for d in range(D):
        lo, hi = corpus.offsets[d], corpus.offsets[d + 1]
        rows = corpus.rows[lo:hi]
        vals = corpus.vals[lo:hi]
        keep = M[rows].sum(axis=1) > 1e-10
        a = vals[keep]
        Ms = M[rows[keep]]
        w_ref, conv_ref = mwu_literal(a, Ms, k, 15, 10.0)
        assert bool(conv[d]) == conv_ref, d
        if conv_ref:
            np.testing.assert_allclose(weights[d], w_ref, rtol=5e-4, atol=1e-5)
            z = Ms @ w_ref
            s = float((a * np.log(z)).sum())
            np.testing.assert_allclose(
                llh_doc[d], s * corpus.avg_doc_sz, rtol=1e-3, atol=1e-4
            )
            np.testing.assert_allclose(
                llh_w[d], s * (hi - lo), rtol=1e-3, atol=1e-4
            )
        else:
            assert llh_doc[d] == 0.0 and (weights[d] == 1.0 / k).all()


def test_empty_doc_unconverged():
    V, D, k = 5, 2, 3
    M = np.full((V, k), 0.2, np.float32)
    corpus = Corpus.from_entries(
        np.array([0]), np.array([1]), np.array([4]),
        vocab_size=V, num_docs=D, normalize_to_one=True,
    )
    batch = build_infer_batch(corpus, M.sum(axis=1))
    weights, conv, llh_doc, _ = infer_all(M, batch, iters=15, Lf=10.0)
    assert conv[0] and not conv[1]
    assert llh_doc[1] == 0.0


def test_small_blocks_match_one_block():
    rng = np.random.default_rng(3)
    V, D, k = 20, 17, 4
    M = make_model(rng, V, k)
    docs = np.repeat(np.arange(D), 3)
    words = rng.integers(1, V, 3 * D)
    order = np.lexsort((words, docs))
    corpus = Corpus.from_entries(
        docs[order], words[order], rng.integers(1, 5, 3 * D)[order],
        vocab_size=V, num_docs=D, normalize_to_one=True,
    )
    batch = build_infer_batch(corpus, M.sum(axis=1))
    w1, c1, l1, _ = infer_all(M, batch, 15, 10.0, block_size=4)
    w2, c2, l2, _ = infer_all(M, batch, 15, 10.0, block_size=0)
    np.testing.assert_allclose(w1, w2, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(c1, c2)
    np.testing.assert_allclose(l1, l2, rtol=1e-5, atol=1e-6)


def test_skewed_lengths_bucketing():
    # Doc lengths spanning buckets: results must match per-doc literal runs.
    rng = np.random.default_rng(5)
    V, k = 400, 4
    M = make_model(rng, V, k)
    docs, words, counts = [], [], []
    lengths = [1, 3, 30, 33, 120, 150, 350]
    for d, n in enumerate(lengths):
        ws = rng.choice(np.arange(1, V), size=n, replace=False)
        for w in np.sort(ws):
            docs.append(d)
            words.append(w)
            counts.append(int(rng.integers(1, 4)))
    corpus = Corpus.from_entries(
        np.array(docs), np.array(words), np.array(counts),
        vocab_size=V, num_docs=len(lengths), normalize_to_one=True,
    )
    batch = build_infer_batch(corpus, M.sum(axis=1))
    weights, conv, llh, _ = infer_all(M, batch, iters=15, Lf=10.0)
    for d in range(len(lengths)):
        lo, hi = corpus.offsets[d], corpus.offsets[d + 1]
        rows, vals = corpus.rows[lo:hi], corpus.vals[lo:hi]
        keep = M[rows].sum(axis=1) > 1e-10
        w_ref, conv_ref = mwu_literal(vals[keep], M[rows[keep]], k, 15, 10.0)
        assert bool(conv[d]) == conv_ref, d
        if conv_ref:
            np.testing.assert_allclose(weights[d], w_ref, rtol=5e-4, atol=1e-5)


def test_compact_blocks_match_f32_blocks():
    """The uint16-counts compact upload path must match the f32-a path
    exactly (same device f32 expression count/doc_sum)."""
    import dataclasses

    rng = np.random.default_rng(11)
    V, D, k = 120, 37, 4
    M = make_model(rng, V, k)
    docs = np.repeat(np.arange(D), 9)
    words = rng.integers(0, V, 9 * D)
    order = np.lexsort((words, docs))
    corpus = Corpus.from_entries(
        docs[order], words[order], rng.integers(1, 300, 9 * D)[order],
        vocab_size=V, num_docs=D, normalize_to_one=True,
    )
    batch = build_infer_batch(corpus, M.sum(axis=1))
    assert batch.counts is not None  # compact sidecar present
    stripped = dataclasses.replace(batch, counts=None, doc_sums=None)
    w1, c1, l1, lw1 = infer_all(M, batch, 15, 10.0)
    w2, c2, l2, lw2 = infer_all(M, stripped, 15, 10.0)
    np.testing.assert_array_equal(c1, c2)
    np.testing.assert_array_equal(w1, w2)
    np.testing.assert_array_equal(l1, l2)
    np.testing.assert_array_equal(lw1, lw2)


def test_top_n_matches_full_weights():
    """top_n mode must reproduce the full path's top entries exactly and
    yield the identical top-topics report."""
    rng = np.random.default_rng(13)
    V, D, k = 80, 23, 6
    M = make_model(rng, V, k)
    docs = np.repeat(np.arange(D), 7)
    words = rng.integers(0, V, 7 * D)
    order = np.lexsort((words, docs))
    corpus = Corpus.from_entries(
        docs[order], words[order], rng.integers(1, 5, 7 * D)[order],
        vocab_size=V, num_docs=D, normalize_to_one=True,
    )
    batch = build_infer_batch(corpus, M.sum(axis=1))
    w_full, c1, l1, _ = infer_all(M, batch, 15, 10.0)
    w_top, c2, l2, _ = infer_all(M, batch, 15, 10.0, top_n=3)
    np.testing.assert_array_equal(c1, c2)
    np.testing.assert_array_equal(l1, l2)
    for d in range(D):
        if not c1[d]:
            continue
        full_top = np.argsort(-w_full[d], kind="stable")[:3]
        expected = np.zeros(k, np.float32)  # non-top filler is 0.0
        expected[full_top] = w_full[d][full_top]
        np.testing.assert_array_equal(w_top[d], expected)
        assert np.argmax(w_top[d]) == np.argmax(w_full[d])


def test_compact_delta_exceptions_large_vocab():
    """Row-delta encoding exceptions: vocab > 65535 so a doc whose first
    word is a high id needs the exception list; results must match the
    fat path exactly."""
    rng = np.random.default_rng(21)
    V, D, k = 80_000, 12, 5
    M = np.zeros((V, k), np.float32)
    act = np.concatenate([rng.integers(0, 200, 40),
                          rng.integers(66000, V, 40)])
    for t in range(k):
        M[act[rng.random(len(act)) < 0.6], t] = rng.random()
    M /= np.maximum(M.sum(axis=0, keepdims=True), 1e-9)
    docs, words, counts = [], [], []
    for d in range(D):
        ws = np.unique(rng.choice(act, 10))
        docs.append(np.full(len(ws), d)); words.append(ws)
        counts.append(rng.integers(1, 5, len(ws)))
    corpus = Corpus.from_entries(
        np.concatenate(docs), np.concatenate(words), np.concatenate(counts),
        vocab_size=V, num_docs=D, normalize_to_one=True,
    )
    batch = build_infer_batch(corpus, M.sum(axis=1))
    assert batch.counts is not None
    # sanity: the encoder really produced exceptions for this data
    from isle_jax.mwu import _encode_row_deltas
    _, exc_i, _ = _encode_row_deltas(batch.word_idx, V)
    assert (exc_i < batch.word_idx.size).any()
    w_c, c1, l1, _ = infer_all(M, batch, 15, 10.0)
    batch_fat = build_infer_batch(corpus, M.sum(axis=1))
    batch_fat.counts = None  # force the fat f32 path
    w_f, c2, l2, _ = infer_all(M, batch_fat, 15, 10.0)
    np.testing.assert_array_equal(c1, c2)
    np.testing.assert_array_equal(w_c, w_f)
    np.testing.assert_array_equal(l1, l2)
