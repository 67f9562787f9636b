"""Sharded streamed (out-of-core x multi-chip) pipeline: must agree with
both the single-device streamed mode and the in-core trainer on the
8-device CPU mesh (VERDICT round-4 item 2)."""

import numpy as np
import pytest

from isle_jax.config import HyperParams, DeviceConfig, TrainConfig
from isle_jax.streaming import StreamedTrainer
from isle_jax.trainer import Trainer
from test_end_to_end import planted_corpus


@pytest.fixture(scope="module")
def corpus_file(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sstream")
    rng = np.random.default_rng(13)
    V, D, k = 60, 300, 4
    text, _ = planted_corpus(rng, V, D, k)
    tdf = tmp / "c.tdf"
    tdf.write_text(text)
    return tmp, str(tdf), V, D, k


def _mesh_cfg(k, **kw):
    return TrainConfig(
        num_topics=k, seed=3,
        hyper=HyperParams(block_ks_block_size=8),
        device=DeviceConfig(mesh_shape=(8,)),
        **kw,
    )


def test_sharded_loader_decodes_corpus(corpus_file):
    """Every chunk of every shard decodes back to the corpus slice."""
    import jax
    from jax.sharding import PartitionSpec as P

    from isle_jax.corpus import Corpus
    from isle_jax.sharding import AXIS, make_mesh
    from isle_jax.streaming_sharded import ShardedResidentLoader

    tmp, tdf, V, D, k = corpus_file
    c = Corpus.from_tdf_file(tdf)
    mesh = make_mesh(8)
    ld = ShardedResidentLoader(c, chunk_entries := 512, mesh)
    assert ld.counts_form

    def f(*args):
        w, v, d = ld.decode_local(*(x[0] for x in args[:-1]), args[-1])
        return w[None], v[None], d[None]

    got = {}
    for i in range(ld.max_chunks):
        w, v, d = jax.shard_map(
            f, mesh=mesh, in_specs=ld.in_specs() + (P(),),
            out_specs=(P(AXIS),) * 3,
        )(*ld.arrays(), i)
        w, v, d = np.asarray(w), np.asarray(v), np.asarray(d)
        for s in range(ld.S):
            m = w[s] < V
            dg = d[s][m] + s * ld.dps
            for wi, vi, di in zip(w[s][m], v[s][m], dg):
                got.setdefault(int(di), []).append((int(wi), float(vi)))
    # reassemble against the host CSC
    for doc in range(D):
        a, b = c.offsets[doc], c.offsets[doc + 1]
        ref = list(zip(c.rows[a:b].tolist(), c.vals[a:b].tolist()))
        assert got.get(doc, []) == ref, f"doc {doc} mismatch"


def test_sharded_streamed_stage_kernels(corpus_file):
    """Thresholds, doc weights, and B agree with the single-device
    streamed kernels entry-for-entry."""
    import jax.numpy as jnp

    from isle_jax.corpus import Corpus
    from isle_jax.sharding import make_mesh
    from isle_jax.sparse import to_dense
    from isle_jax.streaming import streamed_build_b, streamed_thresholds
    from isle_jax.streaming_sharded import (
        ShardedResidentLoader,
        sharded_streamed_build_b,
        sharded_streamed_doc_weights,
        sharded_streamed_thresholds,
    )
    from isle_jax.thresholds import compute_thresholds_np

    tmp, tdf, V, D, k = corpus_file
    c = Corpus.from_tdf_file(tdf)
    hp = HyperParams()
    mesh = make_mesh(8)
    ld = ShardedResidentLoader(c, 512, mesh)

    z, nnz = sharded_streamed_thresholds(ld, k, hp)
    z_ref, nnz_ref = compute_thresholds_np(
        c.rows, c.vals, V, c.avg_doc_sz, c.nz_docs, k, hp
    )
    np.testing.assert_array_equal(z, z_ref)
    assert nnz == nnz_ref

    from isle_jax.streaming import streamed_doc_weights

    w_ref = np.asarray(streamed_doc_weights(c, jnp.asarray(z_ref), 512))
    w_sh = np.asarray(sharded_streamed_doc_weights(ld, z_ref))
    np.testing.assert_allclose(w_sh, w_ref, rtol=1e-6)

    B_sh, oc_sh = sharded_streamed_build_b(ld, z_ref, None)
    B_ref, oc_ref = streamed_build_b(c, jnp.asarray(z_ref), None,
                                     spmm_chunk=256, chunk_entries=512)
    np.testing.assert_array_equal(oc_sh, oc_ref)
    assert B_sh.nnz == B_ref.nnz and B_sh.num_docs == B_ref.num_docs
    # dense reconstruction: per-shard local doc ids + offsets -> global
    dense_sh = np.zeros((V, B_sh.num_docs), np.float32)
    dw = np.asarray(B_sh.d_word)
    dd = np.asarray(B_sh.d_doc)
    dv = np.asarray(B_sh.d_val)
    off = np.asarray(B_sh.doc_offset)[:, 0]
    for s in range(B_sh.num_shards):
        m = dw[s] < V
        dense_sh[dw[s][m], dd[s][m] + off[s]] = dv[s][m]
    np.testing.assert_allclose(dense_sh, to_dense(B_ref), atol=1e-6)
    # word-sorted copies are sorted per shard
    ww = np.asarray(B_sh.w_word)
    for s in range(B_sh.num_shards):
        assert (np.diff(ww[s]) >= 0).all()


def test_sharded_model_thresholds_exact():
    """The psum'd bitwise binary search returns EXACTLY the
    rank_threshold-th largest per topic (vs the in-core sort)."""
    import jax
    from jax.sharding import PartitionSpec as P

    from isle_jax.sharding import make_mesh
    from isle_jax.streaming_sharded import _put, sharded_model_thresholds
    from isle_jax.topic_model import model_thresholds

    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    S, dps, k, rank = 8, 37, 5, 29
    D = S * dps - 11  # ragged tail
    mass_g = np.zeros((S * dps, k), np.float32)
    mass_g[:D] = np.round(rng.random((D, k)) * 100) / 16.0
    mass_g[:D] *= rng.random((D, k)) < 0.7  # plenty of exact zeros + ties
    has_cw = jnp.asarray(np.array([True, True, False, True, True]))

    thr_ref = np.asarray(model_thresholds(
        jnp.asarray(mass_g[:D]), has_cw, rank
    ))
    mesh = make_mesh(8)
    mass_sh = np.zeros((S, dps + 1, k), np.float32)
    mass_sh[:, :dps] = mass_g.reshape(S, dps, k)
    thr_sh = np.asarray(sharded_model_thresholds(
        _put(mesh, mass_sh), has_cw, rank, D, mesh
    ))
    np.testing.assert_array_equal(thr_sh, thr_ref)


@pytest.fixture(scope="module")
def trained_trio(corpus_file):
    """One in-core + one single-device streamed + one mesh-streamed run,
    shared by the equality and resume tests (each full train costs ~15 s
    on the 8-virtual-device CPU host)."""
    tmp, tdf, V, D, k = corpus_file
    cfg_1 = TrainConfig(num_topics=k, seed=3, compute_edge_topics=True,
                        max_edge_topics=5,
                        hyper=HyperParams(block_ks_block_size=8))

    t_in = Trainer(cfg_1, output_dir=str(tmp / "incore"), quiet=True)
    t_in.load_data_from_file(tdf)
    t_in.train()

    t_st = StreamedTrainer(cfg_1, output_dir=str(tmp / "streamed"),
                           chunk_entries=1024)
    t_st._t.load_data_from_file(tdf)
    t_st.train()

    cfg_m = _mesh_cfg(k, compute_edge_topics=True, max_edge_topics=5)
    t_ms = StreamedTrainer(cfg_m, output_dir=str(tmp / "mesh"),
                           chunk_entries=1024)
    t_ms._t.load_data_from_file(tdf)
    t_ms.train()
    return t_in, t_st, t_ms, cfg_m


def test_sharded_streamed_trainer_matches_modes(corpus_file, trained_trio):
    """Full pipeline: sharded-streamed vs single-device streamed vs
    in-core — spectra, doc survival, clusters, and the model agree."""
    tmp, tdf, V, D, k = corpus_file
    t_in, t_st, t_ms, _ = trained_trio

    np.testing.assert_array_equal(t_ms.original_cols, t_in.original_cols)
    np.testing.assert_allclose(
        np.sort(t_ms.evalues), np.sort(t_in.evalues), rtol=1e-3
    )
    np.testing.assert_allclose(t_ms.model.sum(axis=0), 1.0, rtol=1e-4)
    agree_in = (t_ms.cluster_of_doc == t_in.cluster_of_doc).mean()
    agree_st = (t_ms.cluster_of_doc == t_st.cluster_of_doc).mean()
    assert agree_in > 0.95 and agree_st > 0.95
    np.testing.assert_allclose(t_ms.model, t_in.model, atol=2e-3)
    np.testing.assert_allclose(t_ms.model, t_st.model, atol=2e-3)
    # edge topics flow through the same construct_edge_topics_v2
    t_ms._t.train_edge_topics()
    t_in.train_edge_topics()
    assert t_ms._t.edge_model.shape == t_in.edge_model.shape


def test_sharded_streamed_with_sampling(corpus_file):
    """Importance sampling on the mesh: same key schedule as the
    single-device streamed path -> identical selected docs."""
    tmp, tdf, V, D, k = corpus_file
    common = dict(num_topics=k, seed=7, sample_docs=True, sample_rate=0.5,
                  hyper=HyperParams(block_ks_block_size=8))
    cfg_s = TrainConfig(**common)
    t_st = StreamedTrainer(cfg_s, output_dir=str(tmp / "samp_st"),
                           chunk_entries=1024)
    t_st._t.load_data_from_file(tdf)
    t_st.train()

    cfg_m = TrainConfig(device=DeviceConfig(mesh_shape=(8,)), **common)
    t_ms = StreamedTrainer(cfg_m, output_dir=str(tmp / "samp_ms"),
                           chunk_entries=1024)
    t_ms._t.load_data_from_file(tdf)
    t_ms.train()

    np.testing.assert_array_equal(t_ms.original_cols, t_st.original_cols)
    np.testing.assert_allclose(t_ms.model, t_st.model, atol=2e-3)


def test_sharded_streamed_checkpoint_resume(corpus_file, trained_trio):
    """Stage checkpoints interoperate: resume a sharded-streamed run from
    the kmeans checkpoint of the fixture's fresh mesh run (the run dir is
    copied so the fixture stays pristine)."""
    import os
    import shutil

    tmp, tdf, V, D, k = corpus_file
    _, _, t_ms, cfg_m = trained_trio
    model_ref = t_ms.model.copy()

    out = tmp / "ck_resume"
    shutil.copytree(t_ms._t.output_dir, out)
    # strip the final model checkpoint, keep svd+kmeans, resume
    run_dir = os.path.join(out, os.path.basename(t_ms._t.run_dir))
    os.remove(os.path.join(run_dir, "ckpt_model.npz"))
    t2 = StreamedTrainer(cfg_m, output_dir=str(out), chunk_entries=1024)
    t2._t.load_data_from_file(tdf)
    t2.train(resume=True)
    np.testing.assert_allclose(t2.model, model_ref, atol=1e-6)


def test_sharded_streamed_elkans(corpus_file):
    """Elkan's routes through the streamed x mesh composition: same
    cluster memberships as the single-device streamed Elkan's run."""
    tmp, tdf, V, D, k = corpus_file
    common = dict(
        num_topics=k, seed=5,
        hyper=HyperParams(
            block_ks_block_size=8, kmeans_algo_for_sparse="elkans"
        ),
    )
    t_st = StreamedTrainer(TrainConfig(**common),
                           output_dir=str(tmp / "elk_st"),
                           chunk_entries=1024)
    t_st._t.load_data_from_file(tdf)
    t_st.train()

    t_ms = StreamedTrainer(
        TrainConfig(device=DeviceConfig(mesh_shape=(8,)), **common),
        output_dir=str(tmp / "elk_ms"), chunk_entries=1024,
    )
    t_ms._t.load_data_from_file(tdf)
    t_ms.train()

    np.testing.assert_array_equal(
        t_ms._t.cluster_of_doc, t_st._t.cluster_of_doc
    )
    np.testing.assert_allclose(t_ms.model, t_st.model, atol=2e-3)


def test_sharded_loader_rejects_oversize_doc():
    """A doc with more entries than chunk_entries cannot fit any
    doc-aligned chunk window; the loader must refuse loudly (round-4
    review: the grid used to clamp and decode_local silently dropped the
    doc's tail from every streamed pass)."""
    from isle_jax.corpus import Corpus
    from isle_jax.sharding import make_mesh
    from isle_jax.streaming_sharded import ShardedResidentLoader

    ds = np.concatenate([np.zeros(10, np.int64), [1, 1, 2]])
    ws = np.concatenate([np.arange(10), [0, 3, 5]])
    cs = np.ones(13, np.int64)
    corpus = Corpus.from_entries(
        ds, ws, cs, vocab_size=12, num_docs=3, sort_dedup=True
    )
    with pytest.raises(ValueError, match="largest doc"):
        ShardedResidentLoader(corpus, 4, make_mesh(2))


def test_sharded_streamed_middle_oom_fallback(corpus_file, monkeypatch,
                                              tmp_path):
    """RESOURCE_EXHAUSTED during the slab-held sharded middle must release
    the per-shard slabs and retry at the configured head budget; the
    finish passes refill transparently and the outputs match a normal
    run (the mesh form of test_streamed_middle_oom_fallback)."""
    import isle_jax.sharding as sharding_mod

    tmp, tdf, V, D, k = corpus_file
    cfg = TrainConfig(num_topics=k, seed=3, device=DeviceConfig(mesh_shape=(8,)))

    t_ref = StreamedTrainer(cfg, output_dir=str(tmp_path / "ref"),
                            chunk_entries=1024)
    t_ref._t.load_data_from_file(tdf)
    t_ref.train()

    real = sharding_mod.shard_hybrid
    calls = {"n": 0}

    def oom_once(*args, **kwargs):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("RESOURCE_EXHAUSTED: device backend error "
                               "(ResourceExhausted) [simulated]")
        return real(*args, **kwargs)

    monkeypatch.setattr(sharding_mod, "shard_hybrid", oom_once)
    t_oom = StreamedTrainer(cfg, output_dir=str(tmp_path / "oom"),
                            chunk_entries=1024)
    t_oom._t.load_data_from_file(tdf)
    t_oom.train()

    assert calls["n"] == 2  # failed attempt + successful retry
    assert t_oom._loader.fill_count == 2  # released, refilled for finish
    np.testing.assert_array_equal(t_oom.model, t_ref.model)
    np.testing.assert_array_equal(
        t_oom.cluster_of_doc, t_ref.cluster_of_doc
    )
