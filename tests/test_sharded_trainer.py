"""Mesh-orchestrated Trainer equality: Trainer(mesh_shape=(8,)).train() on
the virtual 8-device CPU mesh must reproduce the single-device Trainer on
the same corpus (same zetas, original_cols, cluster memberships, catchword
sets; model/centers to float tolerance).

This is the multi-chip capability test the reference cannot have (it is a
single-node code, SURVEY.md §5.8): the operator and reduction semantics of
reference include/matUtils.h:336-365 and src/sparseMatrix.cpp:1631-1646
run as psum collectives on the mesh.
"""

import dataclasses

import numpy as np
import pytest

from isle_jax.config import HyperParams, DeviceConfig, TrainConfig
from isle_jax.corpus import Corpus
from isle_jax.trainer import Trainer


def _synth_corpus(rng, V, D, k, words_per_doc=24):
    block = V // k
    docs, words, counts = [], [], []
    for d in range(D):
        t = rng.integers(0, k)
        n_main = int(words_per_doc * 0.85)
        ws = np.concatenate(
            [
                rng.integers(t * block, (t + 1) * block, n_main),
                rng.integers(0, V, words_per_doc - n_main),
            ]
        )
        ws, cs = np.unique(ws, return_counts=True)
        docs.append(np.full(len(ws), d))
        words.append(ws)
        counts.append(cs)
    return Corpus.from_entries(
        np.concatenate(docs),
        np.concatenate(words),
        np.concatenate(counts),
        vocab_size=V,
        num_docs=D,
        sort_dedup=True,
    )


def _train(corpus, cfg, tmp_path, tag):
    tr = Trainer(cfg, output_dir=str(tmp_path / tag), quiet=True)
    tr.corpus = corpus
    tr._post_ingest()
    tr.train()
    return tr


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_eq")
    rng = np.random.default_rng(3)
    V, D, k = 96, 400, 4
    corpus = _synth_corpus(rng, V, D, k)
    hyper = HyperParams(block_ks_block_size=8)
    base = TrainConfig(
        num_topics=k, seed=5, hyper=hyper, compute_edge_topics=True,
        max_edge_topics=6,
    )
    single = _train(corpus, base, tmp, "single")
    sharded_cfg = dataclasses.replace(
        base, device=DeviceConfig(mesh_shape=(8,))
    )
    sharded = _train(corpus, sharded_cfg, tmp, "sharded")
    return single, sharded


def test_original_cols_match(pair):
    single, sharded = pair
    np.testing.assert_array_equal(single.original_cols, sharded.original_cols)


def test_eigenvalues_match(pair):
    single, sharded = pair
    np.testing.assert_allclose(
        single.evalues, sharded.evalues, rtol=1e-3, atol=1e-4
    )


def test_cluster_memberships_match(pair):
    single, sharded = pair
    np.testing.assert_array_equal(single.cluster_of_doc, sharded.cluster_of_doc)


def test_centers_match(pair):
    single, sharded = pair
    np.testing.assert_allclose(
        single.centers, sharded.centers, rtol=1e-4, atol=1e-5
    )


def test_catchwords_match(pair):
    single, sharded = pair
    for a, b in zip(single.catchwords, sharded.catchwords):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(
        single.catchword_thresholds,
        sharded.catchword_thresholds,
        rtol=1e-5,
        atol=1e-6,
    )


def test_model_matches(pair):
    single, sharded = pair
    np.testing.assert_allclose(
        single.model, sharded.model, rtol=1e-4, atol=1e-6
    )


def test_top_pairs_match(pair):
    single, sharded = pair
    for a, b in zip(single.top_pairs, sharded.top_pairs):
        np.testing.assert_array_equal(a, b)


def test_edge_topics_match(pair):
    single, sharded = pair
    single.train_edge_topics()
    sharded.train_edge_topics()
    np.testing.assert_array_equal(single.edge_pairs, sharded.edge_pairs)
    np.testing.assert_allclose(
        single.edge_model, sharded.edge_model, rtol=1e-4, atol=1e-6
    )


def test_sharded_sampled_training(pair, tmp_path):
    """Importance sampling under the mesh: global pivot semantics."""
    rng = np.random.default_rng(9)
    V, D, k = 96, 200, 4  # shape only needs to exercise the global pivot
    corpus = _synth_corpus(rng, V, D, k)
    hyper = HyperParams(block_ks_block_size=8)
    base = TrainConfig(
        num_topics=k, seed=5, hyper=hyper, sample_docs=True, sample_rate=0.5
    )
    single = _train(corpus, base, tmp_path, "s_single")
    sharded = _train(
        corpus,
        dataclasses.replace(base, device=DeviceConfig(mesh_shape=(8,))),
        tmp_path,
        "s_sharded",
    )
    np.testing.assert_array_equal(single.original_cols, sharded.original_cols)
    np.testing.assert_allclose(
        single.model, sharded.model, rtol=1e-4, atol=1e-6
    )


def test_sharded_resume(pair, tmp_path):
    """Stage checkpoints restore in sharded mode too."""
    rng = np.random.default_rng(11)
    V, D, k = 96, 160, 4  # resume is shape-independent; keep it cheap
    corpus = _synth_corpus(rng, V, D, k)
    cfg = TrainConfig(
        num_topics=k, seed=2, hyper=HyperParams(block_ks_block_size=8),
        device=DeviceConfig(mesh_shape=(8,)),
    )
    tr = _train(corpus, cfg, tmp_path, "resume")
    tr2 = Trainer(cfg, output_dir=str(tmp_path / "resume"), quiet=True)
    tr2.corpus = corpus
    tr2._post_ingest()
    tr2.train(resume=True)
    np.testing.assert_allclose(tr2.model, tr.model, rtol=1e-6)
    np.testing.assert_array_equal(tr2.cluster_of_doc, tr.cluster_of_doc)


def test_sharded_mwu_inference_matches(pair):
    """Doc-sharded MWU (mesh kwarg) reproduces single-device inference
    (drivers/ISLEInfer.cpp:64-117 doc-parallelism as GSPMD row sharding)."""
    import dataclasses as dc

    from isle_jax.mwu import build_infer_batch, infer_all
    from isle_jax.sharding import make_mesh

    single, _ = pair
    corpus = single.corpus
    infer_corpus = dc.replace(
        corpus,
        vals=(corpus.vals / np.float32(corpus.avg_doc_sz)).astype(np.float32),
    )
    model = single.get_model()
    batch = build_infer_batch(infer_corpus, model.sum(axis=1))
    ref = infer_all(model, batch, iters=15, Lf=10.0)
    got = infer_all(model, batch, iters=15, Lf=10.0, mesh=make_mesh(8))
    np.testing.assert_array_equal(ref[1], got[1])  # converged flags
    np.testing.assert_allclose(got[0], ref[0], rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(got[2], ref[2], rtol=2e-5, atol=1e-5)


def test_sharded_mwu_compact_upload_matches(pair, monkeypatch):
    """The u16 compact upload must survive the mesh path (round-2 gap:
    mesh inference silently fell back to the fat f32 upload). The fat
    kernel is poisoned so any fallback fails the test."""
    from isle_jax import mwu as mwu_mod
    from isle_jax.corpus import Corpus
    from isle_jax.mwu import build_infer_batch, infer_all
    from isle_jax.sharding import make_mesh

    single, _ = pair
    corpus = single.corpus
    # unit-normalized corpus with intact integer counts -> compact path
    infer_corpus = Corpus.from_entries(
        corpus.doc_ids(), corpus.rows, corpus.counts.astype(np.int64),
        vocab_size=corpus.vocab_size, num_docs=corpus.num_docs,
        normalize_to_one=True, sort_dedup=False,
    )
    model = single.get_model()
    batch = build_infer_batch(infer_corpus, model.sum(axis=1))
    assert batch.counts is not None, "compact sidecar must be available"
    ref = infer_all(model, batch, iters=15, Lf=10.0)

    def _poisoned(*a, **kw):
        raise AssertionError("fat upload kernel used despite compact data")

    monkeypatch.setattr(mwu_mod, "_mwu_block", _poisoned)
    got = infer_all(model, batch, iters=15, Lf=10.0, mesh=make_mesh(8))
    np.testing.assert_array_equal(ref[1], got[1])
    np.testing.assert_allclose(got[0], ref[0], rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(got[2], ref[2], rtol=2e-5, atol=1e-5)


def test_sharded_elkans_trainer_matches_single(tmp_path):
    """End-to-end: Trainer(mesh) with kmeans_algo_for_sparse='elkans'
    reproduces the single-device Elkan's trainer (memberships exact,
    centers/model to float tolerance)."""
    rng = np.random.default_rng(11)
    V, D, k = 72, 240, 4
    corpus = _synth_corpus(rng, V, D, k)
    hyper = HyperParams(
        block_ks_block_size=8, kmeans_algo_for_sparse="elkans"
    )
    base = TrainConfig(num_topics=k, seed=9, hyper=hyper)
    single = _train(corpus, base, tmp_path, "elk_single")
    sharded = _train(
        corpus,
        dataclasses.replace(base, device=DeviceConfig(mesh_shape=(8,))),
        tmp_path,
        "elk_sharded",
    )
    np.testing.assert_array_equal(
        single.cluster_of_doc, sharded.cluster_of_doc
    )
    np.testing.assert_allclose(
        single.centers, sharded.centers, rtol=1e-4, atol=1e-5
    )
    np.testing.assert_allclose(
        single.model, sharded.model, rtol=1e-4, atol=1e-6
    )
