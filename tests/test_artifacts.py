"""Reference training-run artifacts: DocCatchword.tsv,
DocTopicCatchwordSums.tsv, TopTwoTopicsPerDoc.txt, M_hat_avg,
TopWordsPerTopic_avg.txt, diversity/coherence reports — format-level
assertions against the reference writers (src/trainer.cpp:705-1040)."""

import os

import numpy as np
import pytest

from isle_jax.config import HyperParams, TrainConfig
from isle_jax.corpus import Corpus
from isle_jax.trainer import Trainer


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("artifacts")
    rng = np.random.default_rng(17)
    V, D, k = 80, 300, 4
    block = V // k
    docs, words, counts = [], [], []
    for d in range(D):
        t = rng.integers(0, k)
        ws = np.concatenate(
            [
                rng.integers(t * block, (t + 1) * block, 20),
                rng.integers(0, V, 4),
            ]
        )
        ws, cs = np.unique(ws, return_counts=True)
        docs.append(np.full(len(ws), d))
        words.append(ws)
        counts.append(cs)
    corpus = Corpus.from_entries(
        np.concatenate(docs), np.concatenate(words), np.concatenate(counts),
        vocab_size=V, num_docs=D, sort_dedup=True,
    )
    cfg = TrainConfig(
        num_topics=k, seed=0, hyper=HyperParams(block_ks_block_size=8),
        compute_edge_topics=True, max_edge_topics=6,
    )
    tr = Trainer(cfg, output_dir=str(tmp), quiet=True)
    tr.corpus = corpus
    tr._post_ingest()
    tr.train()
    tr.output_doc_topic()
    tr.print_top_two_topics()
    tr.output_topic_diversity()
    tr.output_avg_topic_coherence()
    return tr, corpus


def test_doc_catchword_tsv(trained):
    tr, corpus = trained
    path = os.path.join(tr.run_dir, "DocCatchword.tsv")
    data = np.loadtxt(path, ndmin=2)
    assert data.shape[1] == 3
    # 1-based doc/word ids; every word listed is a catchword of some topic
    cw = np.zeros(corpus.vocab_size, bool)
    for ws in tr.catchwords:
        cw[ws] = True
    words = data[:, 1].astype(int) - 1
    assert cw[words].all()
    # entry count = #corpus entries whose word is a catchword
    assert len(data) == int(cw[corpus.rows].sum())
    # values are the normalized counts of those entries
    docs = data[:, 0].astype(int) - 1
    assert (docs >= 0).all() and (docs < corpus.num_docs).all()
    assert (data[:, 2] > 0).all()


def test_doc_topic_catchword_sums(trained):
    tr, corpus = trained
    path = os.path.join(tr.run_dir, "DocTopicCatchwordSums.tsv")
    data = np.loadtxt(path, ndmin=2)
    assert data.shape[1] == 3
    topics = data[:, 1].astype(int) - 1
    vals = data[:, 2]
    # ordered by (topic asc, value desc)
    assert (np.diff(topics) >= 0).all()
    for t in range(tr.config.num_topics):
        sel = vals[topics == t]
        assert (np.diff(sel) <= 1e-6).all()
    # sums reconstruct from the corpus + catchword map
    k = tr.config.num_topics
    cwt = np.full(corpus.vocab_size, -1)
    for t in range(k):
        cwt[tr.catchwords[t]] = t
    mask = cwt[corpus.rows] >= 0
    mass = np.zeros((corpus.num_docs, k), np.float32)
    np.add.at(
        mass,
        (corpus.doc_ids()[mask], cwt[corpus.rows[mask]]),
        corpus.vals[mask],
    )
    assert len(data) == int((mass > 0).sum())
    got = np.zeros_like(mass)
    got[data[:, 0].astype(int) - 1, topics] = vals
    np.testing.assert_allclose(got, mass, atol=2e-6)


def test_top_two_topics_per_doc(trained):
    tr, corpus = trained
    path = os.path.join(tr.run_dir, "TopTwoTopicsPerDoc.txt")
    data = np.loadtxt(path, ndmin=2).astype(int)
    assert data.shape[1] == 3
    t1, t2, valid = tr.top_pairs
    docs = np.flatnonzero(valid)
    np.testing.assert_array_equal(data[:, 0] - 1, docs)
    np.testing.assert_array_equal(data[:, 1] - 1, t1[docs])
    np.testing.assert_array_equal(data[:, 2] - 1, t2[docs])
    assert (data[:, 1] != data[:, 2]).all()


def test_avg_model_files(trained):
    tr, corpus = trained
    from isle_jax.io_text import load_dense_model

    k = tr.config.num_topics
    m = load_dense_model(
        os.path.join(tr.run_dir, "M_hat_avg"), k, corpus.vocab_size
    )
    np.testing.assert_allclose(m.sum(axis=0), 1.0, rtol=1e-4)
    top_path = os.path.join(tr.run_dir, "TopWordsPerTopic_avg.txt")
    lines = open(top_path).read().strip("\n").split("\n")
    assert len(lines) == k


def test_diversity_value(trained):
    tr, _ = trained
    div = tr.output_topic_diversity()
    # planted topics on disjoint word blocks are well-separated
    assert div > 0.0


def test_avg_coherence_matches_catchless_model(trained):
    tr, corpus = trained
    avg, coh = tr.output_avg_topic_coherence()
    assert coh.shape == (tr.config.num_topics,)
    assert np.isfinite(avg)


def test_catchword_detail_dump(trained):
    """output_cluster_summary writes the print_catch_words analog
    (include/logUtils.h:48-65): per topic with catchwords, a diagnostic
    `Catchwords:` line of `word:id(threshold)` entries."""
    import re

    tr, corpus = trained
    tr.output_cluster_summary()
    tr.logger.close()
    diag = open(os.path.join(tr.run_dir, "diagnosticLog.txt")).read()
    assert "Catchwords:" in diag
    entries = re.findall(r"(\S+):(\d+)\(([-\d.e+]+)\)", diag)
    assert entries
    all_cw = {int(w) for ws in tr.catchwords for w in ws}
    for name, wid, thr in entries:
        wid = int(wid)
        assert wid in all_cw
        assert name == tr.vocab_words[wid]
        # threshold matches the stored (k, vocab) matrix at %g precision
        t = next(t for t in range(tr.config.num_topics)
                 if wid in tr.catchwords[t])
        assert float(thr) == float(
            f"{tr.catchword_thresholds[t][wid]:.6g}"
        )
