"""Coverage for model file formats, preprocessed artifacts, diagnostics,
and the observability layer."""

import os

import numpy as np
import pytest

from isle_jax import io_text, native
from isle_jax.corpus import Corpus
from isle_jax.diagnostics import (
    count_distinct_top_five,
    log_combinatorial,
    topic_coherence,
    topic_diversity,
)
from isle_jax.obs import Logger, OpCounter, Timer
from isle_jax.preprocessed import load_preprocessed, save_preprocessed

pytestmark = pytest.mark.quick  # <60s smoke tier


def small_corpus():
    docs = np.array([0, 0, 1, 1, 2], np.int64)
    words = np.array([0, 2, 1, 2, 0], np.int64)
    counts = np.array([2, 1, 3, 1, 5], np.int64)
    return Corpus.from_entries(docs, words, counts, vocab_size=3, num_docs=3)


def test_sparse_model_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    m = rng.random((40, 7)).astype(np.float32)
    m[m < 0.6] = 0.0
    p = str(tmp_path / "model")
    io_text.write_sparse_model(p, m)
    back = io_text.load_sparse_model(p, 7, 40)
    np.testing.assert_allclose(back, np.where(m > 1e-8, m, 0), atol=1e-6)


def test_dense_model_roundtrip(tmp_path):
    rng = np.random.default_rng(1)
    m = rng.random((12, 3)).astype(np.float32)
    p = str(tmp_path / "dense")
    io_text.write_dense_model(p, m)
    back = io_text.load_dense_model(p, 3, 12)
    np.testing.assert_allclose(back, m, rtol=1e-5)


def test_top_words_and_topics(tmp_path):
    m = np.array([[0.5, 0.1], [0.3, 0.0], [0.2, 0.9]], np.float32)
    tops = io_text.top_words_per_topic(m, 2)
    assert tops[0][0][0] == 0 and tops[1][0][0] == 2
    p = str(tmp_path / "tw.txt")
    io_text.write_top_words(p, m, ["a", "b", "c"], 2)
    assert open(p).read().splitlines()[0] == "a\tb"

    w = np.array([[0.7, 0.2, 0.1], [0.2, 0.5, 0.3]], np.float32)
    conv = np.array([True, False])
    pt = str(tmp_path / "tt.txt")
    io_text.write_top_topics(pt, w, conv)
    lines = open(pt).read().splitlines()
    # doc 1 (1-based): topics above 1/3: topic 1 (0.7); doc 2 skipped
    assert lines[0].startswith("1\t1\t0.7")
    assert all(l.split("\t")[0] == "1" for l in lines)


def test_preprocessed_roundtrip(tmp_path):
    c = small_corpus()
    prefix = str(tmp_path / "pp")
    save_preprocessed(c, prefix)
    back = load_preprocessed(prefix)
    assert back.vocab_size == c.vocab_size and back.num_docs == c.num_docs
    np.testing.assert_array_equal(back.offsets, c.offsets)
    np.testing.assert_array_equal(back.rows, c.rows)
    np.testing.assert_allclose(back.vals, c.vals, rtol=1e-6)
    assert back.avg_doc_sz == c.avg_doc_sz
    # CSR sidecar exists and is consistent
    off = np.fromfile(prefix + ".off", dtype=np.int64)
    assert off[-1] == c.nnz


def test_diagnostics():
    c = small_corpus()
    model = np.array(
        [[0.6, 0.1], [0.1, 0.8], [0.3, 0.1]], np.float32
    )
    coh = topic_coherence(c, model, 2)
    assert coh.shape == (2,) and (coh <= 0).all()
    div = topic_diversity(model)
    assert div >= 0
    lc = log_combinatorial(c)
    # doc 0: counts [2,1]: log(3!/2!1!) = log 3
    np.testing.assert_allclose(lc[0], np.log(3.0), rtol=1e-5)
    assert count_distinct_top_five(c, 0) >= 1


def test_timer_logger(tmp_path):
    lg = Logger(str(tmp_path), quiet=True)
    seen = []
    lg.add_sink("info", seen.append)
    t = Timer(lg)
    t.next("phase one")
    lg.info("hello")
    lg.diag("diag line")
    lg.close()
    assert seen == ["hello"]
    assert "phase one" in open(os.path.join(str(tmp_path), "timerLog.txt")).read()
    assert "diag line" in open(
        os.path.join(str(tmp_path), "diagnosticLog.txt")
    ).read()

    oc = OpCounter("x")
    oc.add(2.0, 4e9, 2)
    assert abs(oc.gflops() - 2.0) < 1e-9
    assert "2 calls" in oc.summary()


def test_native_sort_dedup_matches_numpy():
    rng = np.random.default_rng(3)
    n = 5000
    d = rng.integers(0, 50, n)
    w = rng.integers(0, 60, n)
    c = rng.integers(1, 10, n)
    nd, nw, nc = native.sort_dedup_entries(d.copy(), w.copy(), c.copy())
    order = np.lexsort((w, d))
    ds, ws, cs = d[order], w[order], c[order]
    keep = np.ones(n, bool)
    keep[1:] = (ds[1:] != ds[:-1]) | (ws[1:] != ws[:-1])
    np.testing.assert_array_equal(nd, ds[keep])
    np.testing.assert_array_equal(nw, ws[keep])
    np.testing.assert_array_equal(nc, cs[keep])


def test_native_sort_dedup_edge_cases():
    """Adversarial patterns for the radix path: empty, singleton,
    all-equal keys (keep-first count), reverse-sorted, and ids near the
    int32 ceiling (exercises the high key bits)."""
    e = np.array([], np.int64)
    nd, nw, nc = native.sort_dedup_entries(e.copy(), e.copy(), e.copy())
    assert len(nd) == 0

    one = np.array([7], np.int64)
    nd, nw, nc = native.sort_dedup_entries(one.copy(), one.copy(), one.copy())
    assert list(nd) == [7] and list(nc) == [7]

    n = 1000
    d = np.full(n, 42, np.int64)
    w = np.full(n, 13, np.int64)
    c = np.arange(n, dtype=np.int64) + 1
    nd, nw, nc = native.sort_dedup_entries(d.copy(), w.copy(), c.copy())
    assert list(nd) == [42] and list(nw) == [13]
    assert list(nc) == [1]  # keep-FIRST occurrence

    big = (1 << 31) - 1
    d = np.arange(n, dtype=np.int64)[::-1] + (big - n)
    w = np.arange(n, dtype=np.int64)[::-1] % (big - 5) + 5
    c = np.arange(n, dtype=np.int64) + 1
    nd, nw, nc = native.sort_dedup_entries(d.copy(), w.copy(), c.copy())
    order = np.lexsort((w, d))
    np.testing.assert_array_equal(nd, d[order])
    np.testing.assert_array_equal(nw, w[order])
    np.testing.assert_array_equal(nc, c[order])

    # order_by: stability among equal (major, minor) pairs
    maj = np.zeros(64, np.int32)
    mi = np.zeros(64, np.int32)
    perm = native.order_by(maj, mi)
    np.testing.assert_array_equal(perm, np.arange(64))


def _loop_coherence(corpus, model, num_words, eps=1e-5):
    """The pre-vectorization per-pair implementation, kept as the oracle
    (reference loop semantics, src/sparseMatrix.cpp:841-1015)."""
    from isle_jax.io_text import top_words_per_topic

    V = corpus.vocab_size
    k = model.shape[1]
    tops = top_words_per_topic(model, num_words)
    docs = corpus.doc_ids()
    word_docs = {
        w: np.unique(docs[corpus.rows == w])
        for top in tops for w, _ in top
    }
    df = np.bincount(corpus.rows, minlength=V)
    out = np.zeros(k)
    for t in range(k):
        ws = [w for w, wt in tops[t] if wt > 0.0]
        c = 0.0
        for l in range(1, len(ws)):
            for m in range(l):
                joint = np.intersect1d(
                    word_docs[ws[l]], word_docs[ws[m]], assume_unique=True
                ).size
                if df[ws[m]] > 0:
                    c += np.log((joint + eps) / df[ws[m]])
        out[t] = c
    return out.astype(np.float32)


def _loop_distinct_top5(corpus, min_count):
    from collections import Counter

    tops = []
    for d in range(corpus.num_docs):
        lo, hi = corpus.offsets[d], corpus.offsets[d + 1]
        if hi == lo:
            continue
        rows = corpus.rows[lo:hi]
        vals = corpus.vals[lo:hi]
        idx = np.argsort(-vals, kind="stable")[:5]
        tops.append(tuple(sorted(rows[idx].tolist())))
    counts = Counter(tops)
    return sum(1 for v in counts.values() if v > min_count)


def test_vectorized_coherence_matches_loop_oracle():
    rng = np.random.default_rng(5)
    V, D, k = 50, 300, 6
    docs = np.repeat(np.arange(D), 8)
    words = rng.integers(0, V, len(docs))
    counts = rng.integers(1, 5, len(docs))
    c = Corpus.from_entries(docs, words, counts, vocab_size=V, num_docs=D)
    model = rng.random((V, k)).astype(np.float32)
    model /= model.sum(axis=0)
    got = topic_coherence(c, model, 5)
    want = _loop_coherence(c, model, 5)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_vectorized_distinct_top5_matches_loop_oracle():
    rng = np.random.default_rng(6)
    V, D = 30, 400
    lens = rng.integers(0, 9, D)  # includes empty and short docs
    docs = np.repeat(np.arange(D), lens)
    words = rng.integers(0, V, len(docs))
    counts = rng.integers(1, 4, len(docs))
    c = Corpus.from_entries(docs, words, counts, vocab_size=V, num_docs=D)
    for mc in (0, 1, 3):
        assert count_distinct_top_five(c, mc) == _loop_distinct_top5(c, mc)


def test_native_triple_writers_byte_identical(tmp_path):
    """The native buffered triple writers must be byte-identical to the
    per-line Python fallback across sign/magnitude/rounding edge cases."""
    rng = np.random.default_rng(11)
    n = 3000
    a = rng.integers(0, 2**20, n).astype(np.int32)
    b = rng.integers(0, 5000, n).astype(np.int32)
    v = np.concatenate([
        rng.random(n - 6).astype(np.float32) * 1000.0,
        np.array([0.0, 1.0, 0.0000005, 0.1234565, 123456.78, 1e-9],
                 np.float32),
    ])
    p_native = str(tmp_path / "nat.tsv")
    p_py = str(tmp_path / "py.tsv")
    native.write_float_triples(p_native, a, b, v, base_a=1, base_b=1)
    with open(p_py, "w") as f:
        for i in range(n):
            f.write(f"{a[i] + 1}\t{b[i] + 1}\t{v[i]:.6f}\n")
    assert open(p_native, "rb").read() == open(p_py, "rb").read()

    c = rng.integers(0, 100, n).astype(np.int32)
    native.write_int_triples(p_native, a, b, c, base_a=1, base_b=1, base_c=0)
    with open(p_py, "w") as f:
        for i in range(n):
            f.write(f"{a[i] + 1}\t{b[i] + 1}\t{c[i]}\n")
    assert open(p_native, "rb").read() == open(p_py, "rb").read()


def test_write_top_topics_matches_loop_oracle(tmp_path):
    """Vectorized write_top_topics must reproduce the reference per-doc
    loop exactly (order: weight desc, ties to lower topic id, cap 5;
    drivers/ISLEInfer.cpp:100-111) — including duplicate weights and
    unconverged docs."""
    rng = np.random.default_rng(5)
    D, k = 200, 12
    w = rng.random((D, k)).astype(np.float32)
    # force ties and sub-uniform rows
    w[3] = 1.0 / k
    w[7, 2] = w[7, 9] = 0.9
    w[11] = 0.0
    conv = rng.random(D) > 0.2
    p_vec = str(tmp_path / "vec.txt")
    p_loop = str(tmp_path / "loop.txt")
    io_text.write_top_topics(p_vec, w, conv, doc_begin=4, top_n=5)
    uniform = 1.0 / k
    with open(p_loop, "w") as f:
        for d in range(D):
            if not conv[d]:
                continue
            row = w[d]
            idx = np.nonzero(row > uniform)[0]
            idx = idx[np.argsort(-row[idx], kind="stable")][:5]
            for t in idx:
                f.write(f"{d + 4}\t{t + 1}\t{row[t]:.6f}\n")
    assert open(p_vec, "rb").read() == open(p_loop, "rb").read()
