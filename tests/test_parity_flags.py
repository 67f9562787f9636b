"""Round-4 minor-parity surface: the dead-but-present reference build
flags (hyperparams.h:14-25, :54), strict eigensolver convergence
(src/sparseMatrix.cpp:1207), and the CLI's avg-LLH-per-word divisor
(drivers/ISLEInfer.cpp:183)."""

import numpy as np
import pytest

from isle_jax.config import HyperParams, InferConfig, TrainConfig
from isle_jax.corpus import Corpus
from isle_jax.inferencer import Inferencer
from isle_jax.trainer import Trainer


def _entries(rng, V, D, k, words_per_doc=24):
    block = V // k
    ds, ws, cs = [], [], []
    for d in range(D):
        t = rng.integers(0, k)
        n_main = int(words_per_doc * 0.85)
        w = np.concatenate([
            rng.integers(t * block, (t + 1) * block, n_main),
            rng.integers(0, V, words_per_doc - n_main),
        ])
        w, c = np.unique(w, return_counts=True)
        ds.append(np.full(len(w), d))
        ws.append(w)
        cs.append(c)
    return np.concatenate(ds), np.concatenate(ws), np.concatenate(cs)


def test_int_normalized_counts_e2e(tmp_path):
    """USE_INT_NORMALIZED_COUNTS=true trains end-to-end: integer
    normalized values flow through thresholds (whose rounding is a no-op
    on integers), B, SVD, k-means and the topic model."""
    rng = np.random.default_rng(7)
    V, D, k = 60, 240, 4
    d, w, c = _entries(rng, V, D, k)
    cfg = TrainConfig(
        num_topics=k, seed=1,
        hyper=HyperParams(
            block_ks_block_size=8, use_int_normalized_counts=True
        ),
    )
    tr = Trainer(cfg, output_dir=str(tmp_path), quiet=True)
    tr.corpus = Corpus.from_entries(
        d, w, c, vocab_size=V, num_docs=D, int_normalized=True
    )
    assert (tr.corpus.vals == np.floor(tr.corpus.vals)).all()
    tr._post_ingest()
    tr.train()
    model = tr.get_model()
    assert model.shape == (V, k)
    np.testing.assert_allclose(model.sum(axis=0), 1.0, rtol=1e-4)


def test_block_ks_strict_raises(tmp_path):
    """block_ks_strict=True replicates the reference's convergence assert
    (src/sparseMatrix.cpp:1207): an unreachable tolerance must raise
    instead of warning and proceeding."""
    rng = np.random.default_rng(3)
    V, D, k = 60, 240, 4
    d, w, c = _entries(rng, V, D, k)
    cfg = TrainConfig(
        num_topics=k, seed=1,
        hyper=HyperParams(
            block_ks_block_size=8, block_ks_tolerance=0.0,
            block_ks_max_iters=2, block_ks_strict=True,
        ),
    )
    tr = Trainer(cfg, output_dir=str(tmp_path), quiet=True)
    tr.corpus = Corpus.from_entries(d, w, c, vocab_size=V, num_docs=D)
    tr._post_ingest()
    with pytest.raises(RuntimeError, match="converged only"):
        tr.train()


def test_avg_llh_per_word_uses_max_entries(tmp_path):
    """The CLI divides the summed weighted LLH by its max_entries ARGUMENT,
    not the actual entry count (drivers/ISLEInfer.cpp:183)."""
    rng = np.random.default_rng(5)
    V, D, k = 40, 60, 3
    d, w, c = _entries(rng, V, D, k)
    corpus = Corpus.from_entries(
        d, w, c, vocab_size=V, num_docs=D, normalize_to_one=True
    )
    model = rng.random((V, k)).astype(np.float32)
    model /= model.sum(axis=0, keepdims=True)
    inf = Inferencer(
        InferConfig(num_topics=k, vocab_size=V),
        model=model, output_dir=str(tmp_path), quiet=True,
    )
    r_actual = inf.infer_corpus(corpus)
    r_capped = inf.infer_corpus(corpus, max_entries=10 * corpus.nnz)
    assert r_actual.avg_llh_per_word != 0.0
    np.testing.assert_allclose(
        r_capped.avg_llh_per_word, r_actual.avg_llh_per_word / 10.0,
        rtol=1e-6,
    )


def test_kmeansmcmc_sample_size_plumbed(tmp_path):
    """KMEANSMCMC_SAMPLE_SIZE (hyperparams.h:54) is a HyperParams knob
    reaching the AFK-MC^2 chain: different sizes give different seedings
    on a spread-out corpus (same key)."""
    import jax

    from isle_jax.kmeans import kmeans_init_on_projected

    rng = np.random.default_rng(11)
    P = np.asarray(rng.random((6, 400)), np.float32)
    key = jax.random.PRNGKey(0)
    idx_a, _, _ = kmeans_init_on_projected(
        P, 5, 1, key, method="kmeansmcmc", mcmc_sample_size=8
    )
    idx_b, _, _ = kmeans_init_on_projected(
        P, 5, 1, key, method="kmeansmcmc", mcmc_sample_size=300
    )
    assert not np.array_equal(np.asarray(idx_a), np.asarray(idx_b))
    assert HyperParams().kmeansmcmc_sample_size == 10000


def test_eigen_warm_start_trainer(tmp_path):
    """device.eigen_warm_start: a second run in the same output dir seeds the
    Krylov block from the first run's checkpointed U and reproduces the
    model (same pipeline, same seed; only the start basis differs)."""
    from isle_jax.config import DeviceConfig

    rng = np.random.default_rng(2)
    V, D, k = 60, 240, 4
    d, w, c = _entries(rng, V, D, k)

    def _train(cfg):
        tr = Trainer(cfg, output_dir=str(tmp_path), quiet=True)
        tr.corpus = Corpus.from_entries(d, w, c, vocab_size=V, num_docs=D)
        tr._post_ingest()
        tr.train()
        return tr

    hp = HyperParams(block_ks_block_size=8)
    cold = _train(TrainConfig(num_topics=k, seed=1, hyper=hp))
    warm = _train(TrainConfig(
        num_topics=k, seed=1, hyper=hp,
        device=DeviceConfig(eigen_warm_start=True),
    ))
    np.testing.assert_allclose(
        np.sort(warm.evalues), np.sort(cold.evalues), rtol=1e-3
    )
    np.testing.assert_allclose(warm.model, cold.model, atol=2e-3)


@pytest.mark.parametrize("variant", ["sharded", "lanczos"])
def test_eigen_warm_start_other_paths(tmp_path, variant):
    """eigen_warm_start must be honored off the default in-core path too
    (round-4 review: the flag was silently ignored by _train_sharded and
    the lanczos branch)."""
    from isle_jax.config import DeviceConfig

    rng = np.random.default_rng(2)
    V, D, k = 60, 240, 4
    d, w, c = _entries(rng, V, D, k)
    if variant == "sharded":
        hp = HyperParams(block_ks_block_size=8)
        dev_kw = dict(mesh_shape=(4,))
    else:
        hp = HyperParams(eigensolver="lanczos")
        dev_kw = {}

    def _train(cfg):
        tr = Trainer(cfg, output_dir=str(tmp_path), quiet=True)
        tr.corpus = Corpus.from_entries(d, w, c, vocab_size=V, num_docs=D)
        tr._post_ingest()
        tr.train()
        return tr

    cold = _train(TrainConfig(num_topics=k, seed=1, hyper=hp,
                              device=DeviceConfig(**dev_kw)))
    warm = _train(TrainConfig(
        num_topics=k, seed=1, hyper=hp,
        device=DeviceConfig(eigen_warm_start=True, **dev_kw),
    ))
    np.testing.assert_allclose(
        np.sort(warm.evalues), np.sort(cold.evalues), rtol=1e-3
    )
    np.testing.assert_allclose(warm.model, cold.model, atol=2e-3)


def test_drop_flags_e2e_finite_model(tmp_path):
    """Training with the threshold-drop flags on a corpus that actually
    drops words must stay finite end-to-end: the zeta=+inf sentinel used
    to reach row_scale=sqrt(zeta) and NaN the dense-head products when
    a dropped word was selected into the head (round-4 review finding;
    neutralized by hybrid.row_scale_from_zetas)."""
    from isle_jax.thresholds import compute_thresholds_np

    rng = np.random.default_rng(3)
    V0, D, k = 64, 220, 4
    V = V0 + 6  # 6 extra ids the generator never emits -> truly rare
    ds, ws, cs = _entries(rng, V0, D, k)
    # rare words: 2 entries each (far below count_gr) -> too-few-samples
    rare = []
    for j, w_id in enumerate(range(V0, V)):
        rare.append((j % D, w_id, 3))
        rare.append(((j * 7 + 1) % D, w_id, 3))
    ds = np.concatenate([ds, [r[0] for r in rare]])
    ws = np.concatenate([ws, [r[1] for r in rare]])
    cs = np.concatenate([cs, [r[2] for r in rare]])
    corpus = Corpus.from_entries(
        ds, ws, cs, vocab_size=V, num_docs=D, sort_dedup=True
    )
    # few-drop only: bad_threshold_drop would drop the MAIN words too at
    # this shape (counts quantized to 1-3 exhaust the count_eq=3 tie cap)
    # and empty B entirely — that path now raises explicitly (trainer).
    hp = HyperParams(
        block_ks_block_size=8, few_samples_threshold_drop=True,
    )
    # precondition: the flags actually drop at least one word here
    n = corpus.nnz
    order = np.argsort(corpus.rows[:n], kind="stable")
    z, _ = compute_thresholds_np(
        corpus.rows[:n][order], corpus.vals[:n][order], V,
        corpus.avg_doc_sz, corpus.nz_docs, k, hp,
    )
    assert np.isinf(z).any(), "corpus must exercise the drop branch"

    cfg = TrainConfig(num_topics=k, seed=0, hyper=hp)
    tr = Trainer(cfg, output_dir=str(tmp_path / "drop"), quiet=True)
    tr.corpus = corpus
    tr._post_ingest()
    tr.train()
    assert np.isfinite(tr.model).all()
    assert np.isfinite(np.asarray(tr.evalues)).all()


def test_empty_B_raises_explicitly(tmp_path):
    """When thresholding drops every entry (here: bad_threshold_drop on a
    count-quantized corpus that exhausts the count_eq tie cap for every
    word), training raises a clear config error instead of an IndexError
    deep inside a gather (SURVEY §5.3: explicit errors, no silent
    fallbacks)."""
    rng = np.random.default_rng(3)
    V, D, k = 64, 220, 4
    ds, ws, cs = _entries(rng, V, D, k)
    corpus = Corpus.from_entries(
        ds, ws, cs, vocab_size=V, num_docs=D, sort_dedup=True
    )
    hp = HyperParams(
        block_ks_block_size=8, few_samples_threshold_drop=True,
        bad_threshold_drop=True,
    )
    cfg = TrainConfig(num_topics=k, seed=0, hyper=hp)
    tr = Trainer(cfg, output_dir=str(tmp_path / "empty"), quiet=True)
    tr.corpus = corpus
    tr._post_ingest()
    with pytest.raises(ValueError, match="dropped every entry"):
        tr.train()
