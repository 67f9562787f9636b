"""Alternative configurations: kmeans|| and AFK-MC^2 seeding, Elkan's
k-means, edge topics v1, and the C-API embedding surface."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from isle_jax.elkans import run_elkans
from isle_jax.kmeans import (
    kmeans_init_on_projected,
    run_lloyds_full,
    run_lloyds_projected,
)
from isle_jax.sparse import DocSparse, to_dense
from isle_jax.topic_model import construct_edge_topics_v1


def clustered_P(rng, kdim, k, per):
    mus = rng.standard_normal((k, kdim)) * 10
    pts = np.concatenate(
        [mus[i] + 0.1 * rng.standard_normal((per, kdim)) for i in range(k)]
    )
    return jnp.asarray(pts.T, jnp.float32)


@pytest.mark.parametrize("method", ["kmeansbb", "kmeansmcmc"])
def test_alt_seeding_recovers_clusters(method):
    rng = np.random.default_rng(0)
    k, per = 4, 40
    P = clustered_P(rng, 5, k, per)
    idx, centers, residual = kmeans_init_on_projected(
        P, k, 1, jax.random.PRNGKey(0), method=method
    )
    assert centers.shape == (k, 5)
    centers, assign = run_lloyds_projected(P, centers, 10)
    a = np.asarray(assign)
    for i in range(k):
        assert len(np.unique(a[i * per : (i + 1) * per])) == 1
    assert len(np.unique(a)) == k
    if method == "kmeansmcmc":
        assert idx is not None and len(np.unique(np.asarray(idx))) == k


def test_elkans_matches_lloyds_fixpoint():
    rng = np.random.default_rng(1)
    V, D, kc = 30, 90, 3
    w_list, d_list = [], []
    for d in range(D):
        blk = d % kc
        for w in np.sort(rng.choice(np.arange(blk * 10, blk * 10 + 10), 4, replace=False)):
            w_list.append(w)
            d_list.append(d)
    sp = DocSparse.build(
        np.array(w_list), np.array(d_list),
        np.ones(len(w_list), np.float32) * 2, V, D, chunk=512,
    )
    centers0 = jnp.asarray(to_dense(sp)[:, :kc].T)
    c_l, a_l = run_lloyds_full(sp, centers0, 10)
    c_e, a_e = run_elkans(sp, centers0, 10)
    np.testing.assert_array_equal(np.asarray(a_l), np.asarray(a_e))
    np.testing.assert_allclose(np.asarray(c_l), np.asarray(c_e), atol=1e-5)


def test_edge_topics_v1():
    V, D, k = 6, 5, 3
    w = np.array([0, 1, 2, 3, 4, 5])
    d = np.array([0, 0, 1, 2, 3, 4])
    v = np.ones(6, np.float32)
    sp = DocSparse.build(w, d, v, V, D, chunk=64)
    t1 = np.array([0, 0, 1, 2, 2], np.int32)
    t2 = np.array([1, 1, 2, 0, 0], np.int32)
    valid = np.array([True, True, True, True, False])
    edge, sel = construct_edge_topics_v1(sp, t1, t2, valid, None, k, 2)
    # counts: (0,1)=2 docs {0,1}, (1,2)=1 doc {2}, (2,0)=1 doc {3}
    np.testing.assert_array_equal(sel[0, :2], [0, 1])
    # edge 0 = mean of docs 0 and 1 = ([1,1,0,0,0,0] + [0,0,1,0,0,0]) / 2
    np.testing.assert_allclose(edge[:, 0], [0.5, 0.5, 0.5, 0, 0, 0])


def test_capi_roundtrip(tmp_path):
    from isle_jax import capi

    rng = np.random.default_rng(2)
    V, D, k = 40, 120, 3
    logs = []
    h = capi.CreateTrainer(
        V, D, k, output_dir=str(tmp_path), seed=0, log_callback=logs.append
    )
    block = V // k
    for d in range(D):
        t = d % k
        ws = np.unique(rng.integers(t * block, (t + 1) * block, 8)) + 1
        capi.feedData(h, d, ws, np.full(len(ws), 2), len(ws))
    capi.finalizeData(h)
    capi.Train(h)
    model = capi.GetBasicModel(h)
    assert model.shape == (V * k,)
    np.testing.assert_allclose(model.reshape(k, V).sum(axis=1), 1.0, rtol=1e-4)
    assert capi.GetNumEdgeTopics(h) == 0
    assert len(logs) > 0
    capi.DestroyTrainer(h)


def test_elkans_assignment_sequence_matches_oracle():
    """Per-iteration assignment sequence vs the sequential doc-level Elkan
    oracle (literal_oracle.elkans_literal): validates that the vectorized
    flag/compact/mini-SpMM machinery recomputes exactly the docs the
    sequential algorithm would."""
    from literal_oracle import elkans_literal

    rng = np.random.default_rng(4)
    V, D, kc = 24, 60, 3
    dense = np.zeros((V, D), np.float32)
    for d in range(D):
        blk = d % kc
        ws = rng.choice(np.arange(blk * 8, blk * 8 + 8), 4, replace=False)
        dense[ws, d] = rng.integers(1, 4, 4)
    w, d_idx = np.nonzero(dense)
    order = np.lexsort((w, d_idx))
    w, d_idx = w[order], d_idx[order]
    sp = DocSparse.build(
        w, d_idx, dense[w, d_idx].astype(np.float32), V, D, chunk=256
    )
    centers0 = np.asarray(to_dense(sp)[:, :kc].T, np.float64)

    seqs = []

    class SeqTimer:
        def diag(self, msg):
            pass

    # capture the device sequence by instrumenting the loop: rerun with
    # increasing max_reps and record the final assignment each time.
    oracle = elkans_literal(np.asarray(dense, np.float64), centers0, 10)
    for reps in range(1, len(oracle)):
        _, a = run_elkans(sp, jnp.asarray(centers0, jnp.float32), reps,
                          timer=SeqTimer())
        seqs.append(np.asarray(a))
    for got, want in zip(seqs, oracle[1:]):
        np.testing.assert_array_equal(got, want)


def test_elkans_on_hybrid_layout():
    """Elkan's mini-SpMM path must handle the dense-head/sparse-tail
    layout (the trainer passes hybrid B)."""
    from isle_jax.hybrid import to_hybrid

    rng = np.random.default_rng(5)
    V, D, kc = 40, 120, 4
    w_list, d_list, v_list = [], [], []
    for d in range(D):
        blk = d % kc
        ws = np.sort(rng.choice(np.arange(blk * 10, blk * 10 + 10), 5,
                                replace=False))
        for w in ws:
            w_list.append(w)
            d_list.append(d)
            v_list.append(float(rng.integers(1, 4)))
    sp = DocSparse.build(
        np.array(w_list), np.array(d_list), np.array(v_list, np.float32),
        V, D, chunk=512,
    )
    h = to_hybrid(sp, 8, chunk=512)
    centers0 = jnp.asarray(to_dense(sp)[:, :kc].T)
    c_l, a_l = run_lloyds_full(sp, centers0, 10)
    c_e, a_e = run_elkans(h, centers0, 10)
    np.testing.assert_array_equal(np.asarray(a_l), np.asarray(a_e))
    np.testing.assert_allclose(np.asarray(c_l), np.asarray(c_e), atol=1e-5)


class TestImplicitProjection:
    """mat_bt_x_blockwise (USE_EXPLICIT_PROJECTED_MATRIX=false analog,
    src/trainer.cpp:522-531) must agree with the one-shot product on
    every layout — the reference's built-in A/B of the projection stage."""

    def _problem(self, seed, factored):
        import jax.numpy as jnp
        from isle_jax.hybrid import to_hybrid
        from isle_jax.sparse import DocSparse

        rng = np.random.default_rng(seed)
        V, D, nnz = 90, 70, 800
        w = rng.integers(0, V, nnz).astype(np.int32)
        d = np.sort(rng.integers(0, D, nnz).astype(np.int32))
        order = np.lexsort((w, d))
        w, d = w[order], d[order]
        keep = np.ones(nnz, bool)
        keep[1:] = (w[1:] != w[:-1]) | (d[1:] != d[:-1])
        w, d = w[keep], d[keep]
        if factored:
            scale = rng.random(V).astype(np.float32) + 0.5
            v = scale[w]
        else:
            scale = None
            v = rng.random(len(w)).astype(np.float32)
        sp = DocSparse.build(w, d, v, V, D, chunk=256)
        X = rng.standard_normal((V, 16)).astype(np.float32)
        return sp, scale, X

    @pytest.mark.parametrize("doc_block", [7, 16, 64, 1 << 18])
    def test_coo_matches(self, doc_block):
        from isle_jax.matops import mat_bt_x, mat_bt_x_blockwise

        sp, _, X = self._problem(3, factored=False)
        ref = np.asarray(mat_bt_x(sp, X, 256))
        got = np.asarray(mat_bt_x_blockwise(sp, X, doc_block, 256))
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("factored", [False, True])
    @pytest.mark.parametrize("doc_block", [16, 1 << 18])
    def test_hybrid_matches(self, factored, doc_block):
        import jax.numpy as jnp
        from isle_jax.hybrid import to_hybrid
        from isle_jax.matops import mat_bt_x, mat_bt_x_blockwise

        sp, scale, X = self._problem(5, factored=factored)
        h = to_hybrid(
            sp, 16, chunk=256,
            row_scale=None if scale is None else jnp.asarray(scale),
        )
        assert h.head_nnz > 0 and h.nnz > h.head_nnz  # both parts live
        ref = np.asarray(mat_bt_x(h, X, 256))
        got = np.asarray(mat_bt_x_blockwise(h, X, doc_block, 256))
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)

    def test_trainer_ab_harness(self, tmp_path):
        """Full A/B: training with the implicit projection reproduces the
        explicit-projection model (identical seeds; P differs only by
        float summation order)."""
        import dataclasses

        from isle_jax.config import HyperParams, TrainConfig
        from isle_jax.corpus import Corpus
        from isle_jax.trainer import Trainer
        from test_end_to_end import planted_corpus

        rng = np.random.default_rng(31)
        V, D, k = 60, 300, 4
        text, _ = planted_corpus(rng, V, D, k)
        tdf = tmp_path / "c.tdf"
        tdf.write_text(text)

        models = []
        for explicit in (True, False):
            hp = HyperParams(
                block_ks_block_size=8,
                use_explicit_projected_matrix=explicit,
                doc_block_size=64,
            )
            cfg = TrainConfig(num_topics=k, seed=0, hyper=hp)
            tr = Trainer(
                cfg, output_dir=str(tmp_path / f"e{explicit}"), quiet=True
            )
            tr.load_data_from_file(str(tdf))
            tr.train()
            models.append((tr.model, tr.cluster_of_doc))
        np.testing.assert_allclose(
            models[0][0], models[1][0], rtol=1e-4, atol=1e-6
        )
        agree = float(np.mean(models[0][1] == models[1][1]))
        assert agree > 0.99, f"cluster agreement {agree}"


def test_trainer_cross_layout_agreement(tmp_path):
    """Training on the hybrid dense-head layout vs pure COO (head
    disabled) must agree: the layouts compute the same operator up to
    float summation order (the PubMed slab-hold runs showed the head
    SIZE shifts fp roundoff in U, so this pins the cross-layout bar
    end-to-end, like the reference's Spectra-vs-BlockKs mutual check)."""
    import dataclasses

    from isle_jax.config import HyperParams, DeviceConfig, TrainConfig
    from isle_jax.trainer import Trainer
    from test_end_to_end import planted_corpus

    rng = np.random.default_rng(33)
    V, D, k = 60, 300, 4
    text, _ = planted_corpus(rng, V, D, k)
    tdf = tmp_path / "c.tdf"
    tdf.write_text(text)

    models = []
    for head_bytes in (4 << 30, 0):
        cfg = TrainConfig(
            num_topics=k, seed=0,
            hyper=HyperParams(block_ks_block_size=8),
            device=DeviceConfig(dense_head_bytes=head_bytes),
        )
        tr = Trainer(
            cfg, output_dir=str(tmp_path / f"h{head_bytes}"), quiet=True
        )
        tr.load_data_from_file(str(tdf))
        tr.train()
        models.append((tr.model, tr.cluster_of_doc, np.asarray(tr.evalues)))
    np.testing.assert_allclose(models[0][2], models[1][2], rtol=1e-4)
    agree = float(np.mean(models[0][1] == models[1][1]))
    assert agree > 0.99, f"cluster agreement {agree}"
    np.testing.assert_allclose(
        models[0][0], models[1][0], rtol=1e-4, atol=1e-6
    )


def test_trainer_break_head_cap_wiring(tmp_path):
    """DeviceConfig.break_head_cap threads through the in-core trainer: at a
    shape where the int32 cap does not bind, the flag is a bit-exact
    no-op (same num_head => same model/clusters/spectrum); the blocked-
    scatter equality itself is pinned at unit level in test_hybrid."""
    from isle_jax.config import HyperParams, DeviceConfig, TrainConfig
    from isle_jax.trainer import Trainer
    from test_end_to_end import planted_corpus

    rng = np.random.default_rng(43)
    V, D, k = 60, 300, 4
    text, _ = planted_corpus(rng, V, D, k)
    tdf = tmp_path / "c.tdf"
    tdf.write_text(text)

    models = []
    for flag in (False, True):
        cfg = TrainConfig(
            num_topics=k, seed=0,
            hyper=HyperParams(block_ks_block_size=8),
            device=DeviceConfig(break_head_cap=flag),
        )
        tr = Trainer(
            cfg, output_dir=str(tmp_path / f"cb{int(flag)}"), quiet=True
        )
        tr.load_data_from_file(str(tdf))
        tr.train()
        models.append((tr.model, tr.cluster_of_doc))
    np.testing.assert_array_equal(models[0][1], models[1][1])
    np.testing.assert_array_equal(models[0][0], models[1][0])
