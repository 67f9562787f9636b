"""End-to-end pipeline on a synthetic planted-topic corpus: train via the
public API, write model files, infer them back — the reference's own
ISLETrain -> ISLEInfer loop."""

import os

import numpy as np
import pytest

from isle_jax.config import HyperParams, InferConfig, TrainConfig
from isle_jax.inferencer import Inferencer
from isle_jax.trainer import Trainer

pytestmark = pytest.mark.quick  # <60s smoke tier


def planted_corpus(rng, V, D, k, words_per_doc=30):
    """Dominant-admixture corpus: each topic owns a word block; docs draw
    ~85% of tokens from their topic's block."""
    block = V // k
    lines = []
    truth = []
    for d in range(1, D + 1):
        t = rng.integers(0, k)
        truth.append(t)
        n_main = int(words_per_doc * 0.85)
        ws_main = rng.integers(t * block, (t + 1) * block, n_main)
        ws_noise = rng.integers(0, V, words_per_doc - n_main)
        ws, counts = np.unique(
            np.concatenate([ws_main, ws_noise]), return_counts=True
        )
        for w, c in zip(ws, counts):
            lines.append(f"{d} {w + 1} {c}")
    return "\n".join(lines) + "\n", np.array(truth)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("e2e")
    rng = np.random.default_rng(42)
    V, D, k = 60, 240, 4
    text, truth = planted_corpus(rng, V, D, k)
    tdf = tmp / "corpus.tdf"
    tdf.write_text(text)
    cfg = TrainConfig(
        num_topics=k,
        compute_edge_topics=True,
        max_edge_topics=6,
        seed=1,
        hyper=HyperParams(block_ks_block_size=8),
    )
    tr = Trainer(cfg, output_dir=str(tmp), quiet=True)
    tr.load_data_from_file(str(tdf))
    tr.train()
    tr.write_model_to_file()
    tr.train_edge_topics()
    tr.write_edgemodel_to_file()
    return tmp, tr, truth, str(tdf), V, D, k


def test_model_shape_and_normalization(trained):
    _, tr, truth, _, V, D, k = trained
    model = tr.get_model()
    assert model.shape == (V, k)
    np.testing.assert_allclose(model.sum(axis=0), 1.0, rtol=1e-4)
    assert (model >= 0).all()


def test_clusters_recover_planted_topics(trained):
    _, tr, truth, _, V, D, k = trained
    cl = tr.cluster_of_doc
    assigned = cl >= 0
    assert assigned.mean() > 0.9
    # cluster labels should be a near-permutation of planted topics
    agree = 0
    for t in range(k):
        labels, counts = np.unique(cl[assigned & (truth == t)], return_counts=True)
        agree += counts.max()
    assert agree / assigned.sum() > 0.9


def test_topics_concentrate_on_planted_blocks(trained):
    _, tr, truth, _, V, D, k = trained
    model = tr.get_model()
    block = V // k
    for t in range(k):
        w = np.argmax(model[:, t])
        b = w // block
        # the dominant block should carry most of the topic's mass
        mass = model[b * block : (b + 1) * block, t].sum()
        assert mass > 0.5


def test_catchwords_exist_and_disjoint(trained):
    _, tr, *_ = trained
    all_cw = np.concatenate([c for c in tr.catchwords])
    assert len(all_cw) == len(np.unique(all_cw))
    assert sum(len(c) for c in tr.catchwords) > 0


def test_edge_model(trained):
    _, tr, *_ = trained
    assert tr.edge_model is not None and tr.edge_model.shape[1] > 0
    np.testing.assert_allclose(tr.edge_model.sum(axis=0), 1.0, rtol=1e-4)


def test_model_files_roundtrip_and_inference(trained):
    tmp, tr, truth, tdf, V, D, k = trained
    from isle_jax import io_text

    path = os.path.join(tr.run_dir, "M_hat_catch_sparse")
    assert os.path.exists(path)
    loaded = io_text.load_sparse_model(path, k, V)
    np.testing.assert_allclose(loaded, np.where(tr.model > 1e-8, tr.model, 0),
                               atol=2e-6)

    inf = Inferencer(
        InferConfig(num_topics=k, vocab_size=V),
        model_file=path,
        output_dir=str(tmp / "infer"),
        quiet=True,
    )
    result = inf.infer_file(tdf, doc_begin=1, doc_end=D + 1, write_outputs=True)
    assert result.num_converged > 0.9 * D
    assert result.avg_llh_per_word < 0.0
    # inferred dominant topic should match the planted one up to relabeling
    dom = np.argmax(result.weights, axis=1)
    match = 0
    for t in range(k):
        _, counts = np.unique(dom[truth[: len(dom)] == t], return_counts=True)
        match += counts.max()
    assert match / len(dom) > 0.8


def test_dense_oracle_agrees_with_block_ks(trained):
    tmp, tr, truth, tdf, V, D, k = trained
    cfg2 = TrainConfig(
        num_topics=k, seed=1, hyper=HyperParams(eigensolver="dense")
    )
    tr2 = Trainer(cfg2, output_dir=str(tmp / "dense"), quiet=True)
    tr2.load_data_from_file(tdf)
    tr2.train()
    # identical seeds + same eigenspace -> same clustering -> same model
    np.testing.assert_allclose(tr2.model, tr.model, atol=2e-4)


def test_timer_and_checkpoints_written(trained):
    _, tr, *_ = trained
    assert os.path.exists(os.path.join(tr.run_dir, "timerLog.txt"))
    for stage in ("svd", "kmeans", "model"):
        assert os.path.exists(os.path.join(tr.run_dir, f"ckpt_{stage}.npz"))


def test_heldout_inference(trained, tmp_path):
    """Enron-config pattern (BASELINE.md): train on 90% of docs, infer the
    held-out 10%; held-out docs of planted topics should still converge
    and recover their topic."""
    tmp, tr, truth, tdf, V, D, k = trained
    rng = np.random.default_rng(7)
    text, ho_truth = planted_corpus(rng, V, 40, k)
    ho = tmp_path / "heldout.tdf"
    ho.write_text(text)
    from isle_jax import io_text

    path = os.path.join(tr.run_dir, "M_hat_catch_sparse")
    inf = Inferencer(
        InferConfig(num_topics=k, vocab_size=V),
        model_file=path,
        output_dir=str(tmp_path / "out"),
        quiet=True,
    )
    res = inf.infer_file(str(ho), doc_begin=1, doc_end=41, write_outputs=True)
    assert res.num_converged >= 36
    dom = np.argmax(res.weights, axis=1)
    match = 0
    for t in range(k):
        vals, counts = np.unique(dom[ho_truth == t], return_counts=True)
        match += counts.max()
    assert match / len(dom) > 0.75
    files = os.listdir(str(tmp_path / "out"))
    assert any(f.startswith("top_topics_iters_15") for f in files)
