"""Streamed (out-of-core) pipeline must agree with the in-core Trainer."""

import numpy as np
import pytest

from isle_jax.config import HyperParams, TrainConfig
from isle_jax.streaming import (
    StreamedTrainer,
    streamed_build_b,
    streamed_thresholds,
)
from isle_jax.thresholds import compute_thresholds_np
from isle_jax.trainer import Trainer
from test_end_to_end import planted_corpus


@pytest.fixture(scope="module")
def corpus_pair(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("stream")
    rng = np.random.default_rng(11)
    V, D, k = 60, 300, 4
    text, truth = planted_corpus(rng, V, D, k)
    tdf = tmp / "c.tdf"
    tdf.write_text(text)
    return tmp, str(tdf), V, D, k


def test_streamed_thresholds_match(corpus_pair):
    tmp, tdf, V, D, k = corpus_pair
    from isle_jax.corpus import Corpus

    c = Corpus.from_tdf_file(tdf)
    hp = HyperParams()
    z, nnz = streamed_thresholds(c, k, hp, chunk_entries=512)
    z_ref, nnz_ref = compute_thresholds_np(
        c.rows, c.vals, c.vocab_size, c.avg_doc_sz, c.nz_docs, k, hp
    )
    np.testing.assert_array_equal(np.asarray(z), z_ref)
    assert nnz == nnz_ref


def test_streamed_b_matches_incore(corpus_pair):
    tmp, tdf, V, D, k = corpus_pair
    import jax.numpy as jnp

    from isle_jax.bmatrix import threshold_and_copy
    from isle_jax.corpus import Corpus
    from isle_jax.sparse import DocSparse, to_dense

    c = Corpus.from_tdf_file(tdf)
    hp = HyperParams()
    z, _ = streamed_thresholds(c, k, hp, chunk_entries=512)
    B_s, oc_s = streamed_build_b(c, z, None, spmm_chunk=256, chunk_entries=512)
    A = DocSparse.from_corpus(c, chunk=256)
    B_i, oc_i = threshold_and_copy(A, z, chunk=256)
    np.testing.assert_array_equal(oc_s, oc_i)
    assert B_s.nnz == B_i.nnz and B_s.num_docs == B_i.num_docs
    np.testing.assert_allclose(to_dense(B_s), to_dense(B_i), atol=1e-6)
    # word-sorted copy consistent
    ww = np.asarray(B_s.w_word)[: B_s.nnz]
    assert (np.diff(ww) >= 0).all()


def test_streamed_trainer_matches_incore(corpus_pair):
    tmp, tdf, V, D, k = corpus_pair
    cfg = TrainConfig(num_topics=k, seed=3, compute_edge_topics=True,
                      max_edge_topics=5,
                      hyper=HyperParams(block_ks_block_size=8))
    t1 = Trainer(cfg, output_dir=str(tmp / "a"), quiet=True)
    t1.load_data_from_file(tdf)
    t1.train()

    t2 = StreamedTrainer(cfg, output_dir=str(tmp / "b"), chunk_entries=1024)
    t2._t.load_data_from_file(tdf)
    t2.train()

    # same thresholds -> same B -> same spectrum; clustering/model agree to
    # fp tolerance (different but equivalent solver paths/seeds schedules)
    np.testing.assert_allclose(
        np.sort(t2.evalues), np.sort(t1.evalues), rtol=1e-3
    )
    np.testing.assert_array_equal(t2.original_cols, t1.original_cols)
    assert t2.model.shape == t1.model.shape
    np.testing.assert_allclose(t2.model.sum(axis=0), 1.0, rtol=1e-4)
    # identical seed + identical stages where shared: clusters should agree
    agree = (t2.cluster_of_doc == t1.cluster_of_doc).mean()
    assert agree > 0.95
    np.testing.assert_allclose(t2.model, t1.model, atol=2e-3)


def test_trainer_preprocessed_ingest(corpus_pair):
    """PREPROCESSED_DATA_LOAD mode: save binary sidecars, train from them;
    results match the text-ingest path (raw counts are absent, so the
    compact upload falls back to direct transfer)."""
    from isle_jax.corpus import Corpus
    from isle_jax.preprocessed import save_preprocessed

    tmp, tdf, V, D, k = corpus_pair
    c = Corpus.from_tdf_file(tdf)
    prefix = str(tmp / "pp")
    save_preprocessed(c, prefix)

    cfg = TrainConfig(num_topics=k, seed=3,
                      hyper=HyperParams(block_ks_block_size=8))
    t1 = Trainer(cfg, output_dir=str(tmp / "pp_run"), quiet=True)
    t1.load_preprocessed(prefix)
    t1.train()

    t2 = Trainer(cfg, output_dir=str(tmp / "txt_run"), quiet=True)
    t2.load_data_from_file(tdf)
    t2.train()
    np.testing.assert_allclose(t1.model, t2.model, atol=2e-4)


def test_checkpoint_resume(corpus_pair):
    """Resume from each checkpoint stage reproduces the fresh-run model."""
    tmp, tdf, V, D, k = corpus_pair
    cfg = TrainConfig(num_topics=k, seed=5, compute_edge_topics=True,
                      max_edge_topics=4,
                      hyper=HyperParams(block_ks_block_size=8))
    t0 = Trainer(cfg, output_dir=str(tmp / "ck"), quiet=True)
    t0.load_data_from_file(tdf)
    t0.train()
    ref_model = t0.model.copy()
    ref_cl = t0.cluster_of_doc.copy()

    import os

    # resume from 'model': instant restore
    t1 = Trainer(cfg, output_dir=str(tmp / "ck"), quiet=True)
    t1.load_data_from_file(tdf)
    t1.train(resume=True)
    np.testing.assert_array_equal(t1.model, ref_model)
    assert t1.is_training_complete and t1.top_pairs is not None
    t1.train_edge_topics()  # pairs restored -> edge topics work

    # resume from 'kmeans': drop the model ckpt, recompute stages 10-12
    os.remove(os.path.join(t0.run_dir, "ckpt_model.npz"))
    t2 = Trainer(cfg, output_dir=str(tmp / "ck"), quiet=True)
    t2.load_data_from_file(tdf)
    t2.train(resume=True)
    np.testing.assert_array_equal(t2.cluster_of_doc, ref_cl)
    np.testing.assert_allclose(t2.model, ref_model, atol=1e-6)

    # resume from 'svd': drop the kmeans ckpt too
    os.remove(os.path.join(t0.run_dir, "ckpt_kmeans.npz"))
    t3 = Trainer(cfg, output_dir=str(tmp / "ck"), quiet=True)
    t3.load_data_from_file(tdf)
    t3.train(resume=True)
    np.testing.assert_allclose(t3.model, ref_model, atol=2e-4)


def test_streamed_resume(tmp_path):
    """Stage checkpoints restore in the streamed mode (the out-of-core
    path most needs mid-run restartability; reference restarts only from
    final artifacts, SURVEY.md §5.4)."""
    import os

    from isle_jax.streaming import StreamedTrainer

    rng = np.random.default_rng(12)
    corpus = _synth(rng, V=60, D=200, k=4) if "_synth" in globals() else None
    if corpus is None:
        # build inline
        V, D, k = 60, 200, 4
        block = V // k
        docs, words, counts = [], [], []
        for d in range(D):
            t = rng.integers(0, k)
            ws = np.concatenate([
                rng.integers(t * block, (t + 1) * block, 14),
                rng.integers(0, V, 3),
            ])
            ws, cs = np.unique(ws, return_counts=True)
            docs.append(np.full(len(ws), d))
            words.append(ws)
            counts.append(cs)
        from isle_jax.corpus import Corpus

        corpus = Corpus.from_entries(
            np.concatenate(docs), np.concatenate(words),
            np.concatenate(counts), vocab_size=V, num_docs=D,
            sort_dedup=True,
        )
    from isle_jax.config import HyperParams, TrainConfig

    cfg = TrainConfig(
        num_topics=4, seed=3, hyper=HyperParams(block_ks_block_size=8)
    )
    st = StreamedTrainer(cfg, output_dir=str(tmp_path), quiet=True,
                         chunk_entries=1 << 10)
    st._t.corpus = corpus
    st._t._post_ingest()
    st.train()
    for stage in ("svd", "kmeans", "model"):
        assert os.path.exists(
            os.path.join(st._t.run_dir, f"ckpt_{stage}.npz")
        ), stage

    st2 = StreamedTrainer(cfg, output_dir=str(tmp_path), quiet=True,
                          chunk_entries=1 << 10)
    st2._t.corpus = corpus
    st2._t._post_ingest()
    st2.train(resume=True)
    np.testing.assert_allclose(st2._t.model, st._t.model, rtol=1e-6)
    np.testing.assert_array_equal(
        st2._t.cluster_of_doc, st._t.cluster_of_doc
    )

    # partial resume: drop the model checkpoint, keep svd+kmeans
    os.remove(os.path.join(st._t.run_dir, "ckpt_model.npz"))
    st3 = StreamedTrainer(cfg, output_dir=str(tmp_path), quiet=True,
                          chunk_entries=1 << 10)
    st3._t.corpus = corpus
    st3._t._post_ingest()
    st3.train(resume=True)
    np.testing.assert_allclose(st3._t.model, st._t.model, rtol=1e-6)


def test_chunk_loader_nibble_exceptions():
    """The streamed compact loader's nibble-packed count path must
    restore counts >= 15 exactly via the per-chunk exception list, and
    fall back to wider count dtypes when big counts dominate. Rebuilt
    (w, v, d) must match the fat upload bit-for-bit on the IEEE CPU
    backend (values are avg * count / doc_sum in f32 both ways)."""
    import dataclasses

    from isle_jax.corpus import Corpus
    from isle_jax.streaming import doc_chunks, make_chunk_loader

    rng = np.random.default_rng(5)
    V, D, nnz = 40, 120, 900
    d = np.sort(rng.integers(0, D, nnz))
    w = rng.integers(0, V, nnz)
    key = np.unique(d.astype(np.int64) * V + w)
    d, w = (key // V).astype(np.int64), (key % V).astype(np.int64)
    cnt = rng.integers(1, 8, len(key)).astype(np.int64)
    # ~1% big counts: nibble stays on, exceptions exercised
    big = rng.choice(len(key), max(len(key) // 100, 3), replace=False)
    cnt[big] = rng.integers(15, 300, len(big))
    corpus = Corpus.from_entries(d, w, cnt, vocab_size=V, num_docs=D)

    fat = make_chunk_loader(
        dataclasses.replace(corpus, counts=None), 128
    )
    compact = make_chunk_loader(corpus, 128)
    for lo, hi in doc_chunks(corpus, 128):
        for a, b in zip(fat(lo, hi), compact(lo, hi)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    # >2% big counts: nibble disabled, u16 dtype path, same equality
    cnt2 = cnt.copy()
    cnt2[: len(cnt2) // 4] = 77
    corpus2 = Corpus.from_entries(d, w, cnt2, vocab_size=V, num_docs=D)
    fat2 = make_chunk_loader(dataclasses.replace(corpus2, counts=None), 128)
    compact2 = make_chunk_loader(corpus2, 128)
    for lo, hi in doc_chunks(corpus2, 128):
        for a, b in zip(fat2(lo, hi), compact2(lo, hi)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_resident_loader_matches_wire_loaders():
    """The device-resident loader must return chunk-identical (w, v, d)
    to the per-pass loaders in both storage forms, and get_corpus_loader
    must fall back to per-pass streaming when over budget."""
    import dataclasses

    from isle_jax.corpus import Corpus
    from isle_jax.streaming import (
        ResidentLoader,
        doc_chunks,
        get_corpus_loader,
        make_chunk_loader,
    )

    rng = np.random.default_rng(17)
    V, D = 50, 140
    d = np.sort(rng.integers(0, D, 1100))
    w = rng.integers(0, V, len(d))
    key = np.unique(d.astype(np.int64) * V + w)
    d, w = (key // V).astype(np.int64), (key % V).astype(np.int64)
    cnt = rng.integers(1, 8, len(key)).astype(np.int64)
    big = rng.choice(len(key), 5, replace=False)
    cnt[big] = rng.integers(15, 70000, 5)  # u16 dtype + nibble exceptions
    corpus = Corpus.from_entries(d, w, cnt, vocab_size=V, num_docs=D)

    # counts form vs compact wire loader
    res = get_corpus_loader(corpus, 128, resident_bytes=1 << 30)
    assert isinstance(res, ResidentLoader)
    wire = make_chunk_loader(corpus, 128)
    for lo, hi in doc_chunks(corpus, 128):
        for a, b in zip(wire(lo, hi), res(lo, hi)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    # vals form (custom normalization disables the counts encoding)
    corpus2 = dataclasses.replace(
        corpus,
        vals=(corpus.counts.astype(np.float32)
              / np.repeat(corpus.doc_sums(), np.diff(corpus.offsets))
              ).astype(np.float32),
    )
    res2 = ResidentLoader(corpus2, 128)
    fat2 = make_chunk_loader(corpus2, 128)
    assert res2._plan is None
    for lo, hi in doc_chunks(corpus2, 128):
        for a, b in zip(fat2(lo, hi), res2(lo, hi)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    # over budget -> per-pass loader
    small = get_corpus_loader(corpus, 128, resident_bytes=16)
    assert not isinstance(small, ResidentLoader)
    # budget 0 -> per-pass loader without even computing the plan
    off = get_corpus_loader(corpus, 128, resident_bytes=0)
    assert not isinstance(off, ResidentLoader)


def test_plan_middle_budget():
    """Slab-vs-head policy: keep the resident corpus whenever the middle
    fits beside it (shrinking, then dropping, the dense head), release
    only when even the no-head middle cannot fit."""
    from isle_jax.streaming import plan_middle_budget

    GiB = 1 << 30
    # plenty of room: keep slabs, full configured head
    keep, head = plan_middle_budget(14 * GiB, 100 << 20, 1_000_000, 4 * GiB)
    assert keep and head == 4 * GiB
    # the PubMed shape (slabs ~4.2 GB, nnz(B) 79.4M): the full 4 GiB head
    # + slabs OOM'd the 16 GB chip, so the head must shrink, not the slabs
    keep, head = plan_middle_budget(
        14 * GiB, 4_170_000_000, 79_400_000, 4 * GiB
    )
    assert keep and 0 < head < 4 * GiB
    # tighter: drop the head entirely but keep the slabs (a refill costs
    # a full corpus re-upload; the head only saves seconds of SpMM)
    keep, head = plan_middle_budget(
        8 * GiB, 4_170_000_000, 79_400_000, 4 * GiB
    )
    assert keep and head == 0
    # impossible even without the head: release (round-2 behavior)
    keep, head = plan_middle_budget(
        6 * GiB, 4_170_000_000, 79_400_000, 4 * GiB
    )
    assert not keep and head == 4 * GiB
    # head disabled by config: keep iff the no-head middle fits
    keep, head = plan_middle_budget(14 * GiB, 100 << 20, 1_000_000, 0)
    assert keep and head == 0


def test_streamed_release_path_matches_keep_path(corpus_pair):
    """Forcing the round-2 release-and-refill path (tiny hbm budget) must
    produce bitwise the keep path's model, paying exactly one extra
    resident fill."""
    import dataclasses

    from isle_jax.config import DeviceConfig
    from isle_jax.streaming import ResidentLoader

    tmp, tdf, V, D, k = corpus_pair
    cfg_keep = TrainConfig(num_topics=k, seed=3)
    t_keep = StreamedTrainer(cfg_keep, output_dir=str(tmp / "keep"),
                             chunk_entries=1024)
    t_keep._t.load_data_from_file(tdf)
    t_keep.train()
    assert isinstance(t_keep._loader, ResidentLoader)
    assert t_keep._loader.fill_count == 1  # slabs held end to end

    cfg_rel = dataclasses.replace(
        cfg_keep, device=dataclasses.replace(cfg_keep.device, hbm_bytes=1 << 20)
    )
    t_rel = StreamedTrainer(cfg_rel, output_dir=str(tmp / "rel"),
                            chunk_entries=1024)
    t_rel._t.load_data_from_file(tdf)
    t_rel.train()
    assert t_rel._loader.fill_count == 2  # released + refilled for finish

    np.testing.assert_array_equal(t_rel.model, t_keep.model)
    np.testing.assert_array_equal(t_rel.cluster_of_doc, t_keep.cluster_of_doc)


def test_streamed_middle_oom_fallback(corpus_pair, monkeypatch, tmp_path):
    """RESOURCE_EXHAUSTED during the slab-held middle must release the
    slabs and retry at the configured head budget, matching the normal
    run's outputs."""
    import isle_jax.hybrid as hybrid_mod

    tmp, tdf, V, D, k = corpus_pair
    cfg = TrainConfig(num_topics=k, seed=3)

    t_ref = StreamedTrainer(cfg, output_dir=str(tmp_path / "ref"),
                            chunk_entries=1024)
    t_ref._t.load_data_from_file(tdf)
    t_ref.train()

    real = hybrid_mod.to_hybrid
    calls = {"n": 0}

    def oom_once(*args, **kwargs):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("RESOURCE_EXHAUSTED: device backend error "
                               "(ResourceExhausted) [simulated]")
        return real(*args, **kwargs)

    monkeypatch.setattr(hybrid_mod, "to_hybrid", oom_once)
    t_oom = StreamedTrainer(cfg, output_dir=str(tmp_path / "oom"),
                            chunk_entries=1024)
    t_oom._t.load_data_from_file(tdf)
    t_oom.train()

    assert calls["n"] == 2  # failed attempt + successful retry
    assert t_oom._loader.fill_count == 2  # released, refilled for finish
    np.testing.assert_array_equal(t_oom.model, t_ref.model)
    np.testing.assert_array_equal(t_oom.cluster_of_doc, t_ref.cluster_of_doc)
