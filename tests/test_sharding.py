"""Doc-sharded SpMM and the composite sharded train step on the 8-device
virtual CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from isle_jax.sharding import (
    from_doc_sparse,
    make_mesh,
    shard_doc_sparse,
    sharded_b_y,
    sharded_bt_x,
    sharded_gram_x,
    sharded_train_step,
)
from isle_jax.sparse import DocSparse, b_y, bt_x, gram_x


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(0)
    V, D = 50, 80
    mask = rng.random((V, D)) < 0.2
    w, d = np.nonzero(mask)
    order = np.lexsort((w, d))
    w, d = w[order], d[order]
    v = rng.integers(1, 5, len(w)).astype(np.float32)
    sp = DocSparse.build(w, d, v, V, D, chunk=1024)
    mesh = make_mesh()
    ssp = shard_doc_sparse(w, d, v, V, D, mesh, pad_multiple=64)
    return sp, ssp, mesh, (w, d, v, V, D)


def test_mesh_has_8_devices(problem):
    _, _, mesh, _ = problem
    assert mesh.devices.size == 8


def test_sharded_bt_x_matches(problem):
    sp, ssp, mesh, (w, d, v, V, D) = problem
    rng = np.random.default_rng(1)
    X = jnp.asarray(rng.standard_normal((V, 8)).astype(np.float32))
    ref = np.asarray(bt_x(sp, X))
    got = np.asarray(sharded_bt_x(ssp, X, mesh)).reshape(-1, 8)[:D]
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_sharded_b_y_matches(problem):
    sp, ssp, mesh, (w, d, v, V, D) = problem
    rng = np.random.default_rng(2)
    S, dps = ssp.num_shards, ssp.docs_per_shard
    Yg = rng.standard_normal((S * dps, 4)).astype(np.float32)
    Yg[D:] = 0.0
    ref = np.asarray(b_y(sp, jnp.asarray(Yg[:D])))
    got = np.asarray(sharded_b_y(ssp, jnp.asarray(Yg.reshape(S, dps, 4)), mesh))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_sharded_gram_matches(problem):
    sp, ssp, mesh, (w, d, v, V, D) = problem
    rng = np.random.default_rng(3)
    X = jnp.asarray(rng.standard_normal((V, 8)).astype(np.float32))
    ref = np.asarray(gram_x(sp, X))
    got = np.asarray(sharded_gram_x(ssp, X, mesh))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_sharded_train_step_runs(problem):
    sp, ssp, mesh, (w, d, v, V, D) = problem
    k = 4
    rng = np.random.default_rng(4)
    step = sharded_train_step(ssp, mesh, k)
    X = jnp.asarray(rng.standard_normal((V, 8)).astype(np.float32))
    centers = jnp.asarray(rng.standard_normal((k, V)).astype(np.float32))
    Y, assign, new_centers, hist = step(ssp, X, centers)
    assert Y.shape == (V, 8)
    assert new_centers.shape == (k, V)
    assert int(hist.sum()) == len(w)
    # assignments cover real docs
    a = np.asarray(assign).reshape(-1)[:D]
    assert ((a >= 0) & (a < k)).all()


def test_sharded_thresholds_matches_single(problem):
    from isle_jax.config import HyperParams
    from isle_jax.sharding import shard_by_word, sharded_thresholds
    from isle_jax.thresholds import compute_thresholds_np

    sp, ssp, mesh, (w, d, v, V, D) = problem
    hp = HyperParams()
    avg, nz, k = 6.0, D, 3
    ws = shard_by_word(w, d, v, V, D, mesh, pad_multiple=64)
    zetas, nnz = sharded_thresholds(ws, avg, nz, k, hp, mesh)
    z_ref, nnz_ref = compute_thresholds_np(w, v, V, avg, nz, k, hp)
    np.testing.assert_array_equal(zetas, z_ref)
    assert nnz == nnz_ref


def test_sharded_thresholds_drop_flags(problem):
    """Flipping the threshold-drop flags IN THE SAME PROCESS must change
    the mesh thresholds and match the single-device frontend. Guards the
    sharding._sm cache key: an under-keyed cached program would silently
    reuse the unflagged constants (the flags are baked into the compiled
    stage)."""
    from isle_jax.config import HyperParams
    from isle_jax.sharding import shard_by_word, sharded_thresholds
    from isle_jax.thresholds import compute_thresholds_np

    sp, ssp, mesh, (w, d, v, V, D) = problem
    avg, nz, k = 6.0, D, 3
    ws = shard_by_word(w, d, v, V, D, mesh, pad_multiple=64)
    base, _ = sharded_thresholds(ws, avg, nz, k, HyperParams(), mesh)
    for hp in (
        HyperParams(few_samples_threshold_drop=True),
        HyperParams(bad_threshold_drop=True),
    ):
        zetas, nnz = sharded_thresholds(ws, avg, nz, k, hp, mesh)
        z_ref, nnz_ref = compute_thresholds_np(w, v, V, avg, nz, k, hp)
        np.testing.assert_array_equal(zetas, z_ref)
        assert nnz == nnz_ref
        assert not np.array_equal(zetas, base)


def test_sharded_rth_matches_single(problem):
    from isle_jax.catchwords import rth_highest
    from isle_jax.sharding import shard_by_word, sharded_rth_highest

    sp, ssp, mesh, (w, d, v, V, D) = problem
    rng = np.random.default_rng(7)
    k = 4
    cluster = rng.integers(-1, k, D).astype(np.int32)
    sizes = np.bincount(cluster[cluster >= 0], minlength=k).astype(np.int32)
    ws = shard_by_word(w, d, v, V, D, mesh, pad_multiple=64)
    got = sharded_rth_highest(ws, cluster, sizes, k, 2, mesh)
    ref = np.asarray(
        rth_highest(sp, jnp.asarray(cluster), jnp.asarray(sizes), k, 2)
    )
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


@pytest.fixture(scope="module")
def hybrid_problem():
    """Row-constant values (the factored-layout premise: every nonzero of
    row w equals scale[w], as in the thresholded B)."""
    from isle_jax.sharding import shard_hybrid

    rng = np.random.default_rng(7)
    V, D = 60, 100
    mask = rng.random((V, D)) < 0.25
    # skew some rows heavy so head selection is non-trivial
    mask[:8, :] = rng.random((8, D)) < 0.8
    w, d = np.nonzero(mask)
    order = np.lexsort((w, d))
    w, d = w[order], d[order]
    scale = (rng.random(V).astype(np.float32) + 0.5)
    v = scale[w]
    sp = DocSparse.build(w, d, v, V, D, chunk=1024)
    mesh = make_mesh()
    ssp = shard_doc_sparse(w, d, v, V, D, mesh, pad_multiple=64)
    # head budget for ~V//3 rows
    budget = 2 * ssp.docs_per_shard * ssp.num_shards * (V // 3)
    h = shard_hybrid(ssp, scale, mesh, budget, chunk=64)
    assert 0 < h.num_head < V  # real head AND real tail
    return sp, ssp, h, mesh, (V, D)


def test_sharded_hybrid_bt_x_matches(hybrid_problem):
    from isle_jax.sharding import sharded_h_bt_x

    sp, ssp, h, mesh, (V, D) = hybrid_problem
    rng = np.random.default_rng(11)
    X = jnp.asarray(rng.standard_normal((V, 8)).astype(np.float32))
    ref = np.asarray(bt_x(sp, X))
    got = np.asarray(sharded_h_bt_x(h, X, mesh)).reshape(-1, 8)[:D]
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_sharded_hybrid_b_y_matches(hybrid_problem):
    from isle_jax.sharding import sharded_h_b_y

    sp, ssp, h, mesh, (V, D) = hybrid_problem
    rng = np.random.default_rng(12)
    S, dps = ssp.num_shards, ssp.docs_per_shard
    Yg = rng.standard_normal((S * dps, 4)).astype(np.float32)
    Yg[D:] = 0.0
    ref = np.asarray(b_y(sp, jnp.asarray(Yg[:D])))
    got = np.asarray(
        sharded_h_b_y(h, jnp.asarray(Yg.reshape(S, dps, 4)), mesh)
    )
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_sharded_hybrid_gram_matches(hybrid_problem):
    from isle_jax.sharding import sharded_h_gram_x

    sp, ssp, h, mesh, (V, D) = hybrid_problem
    rng = np.random.default_rng(13)
    X = jnp.asarray(rng.standard_normal((V, 8)).astype(np.float32))
    ref = np.asarray(gram_x(sp, X))
    got = np.asarray(sharded_h_gram_x(h, X, mesh))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_sharded_hybrid_lloyds_matches_coo(hybrid_problem):
    from isle_jax.sharding import sharded_run_lloyds_full

    sp, ssp, h, mesh, (V, D) = hybrid_problem
    rng = np.random.default_rng(21)
    k = 4
    centers = jnp.asarray(rng.standard_normal((k, V)).astype(np.float32))
    c1, a1 = sharded_run_lloyds_full(ssp, centers, 5, mesh)
    c2, a2 = sharded_run_lloyds_full(h, centers, 5, mesh)
    np.testing.assert_array_equal(a1, a2)
    np.testing.assert_allclose(np.asarray(c1), np.asarray(c2),
                               rtol=1e-4, atol=1e-5)


def test_sharded_elkans_matches_single(problem):
    """sharded_run_elkans reproduces the single-device Elkan's fixpoint
    (same seed centers -> same assignment and centers)."""
    from isle_jax.elkans import run_elkans
    from isle_jax.elkans_sharded import sharded_run_elkans

    sp, ssp, mesh, (w, d, v, V, D) = problem
    rng = np.random.default_rng(31)
    k = 4
    centers = jnp.asarray(rng.standard_normal((k, V)).astype(np.float32))
    c_ref, a_ref = run_elkans(sp, centers, 12)
    c_got, a_got = sharded_run_elkans(ssp, centers, 12, mesh)
    np.testing.assert_array_equal(np.asarray(a_got), np.asarray(a_ref))
    np.testing.assert_allclose(
        np.asarray(c_got), np.asarray(c_ref), rtol=1e-4, atol=1e-5
    )


def test_sharded_elkans_matches_lloyds_fixpoint(problem):
    """Same fixpoint as the sharded Lloyd's (up to exact-tie ordering,
    which random centers make measure-zero)."""
    from isle_jax.elkans_sharded import sharded_run_elkans
    from isle_jax.sharding import sharded_run_lloyds_full

    sp, ssp, mesh, (w, d, v, V, D) = problem
    rng = np.random.default_rng(33)
    k = 3
    centers = jnp.asarray(rng.standard_normal((k, V)).astype(np.float32))
    c1, a1 = sharded_run_lloyds_full(ssp, centers, 25, mesh)
    c2, a2 = sharded_run_elkans(ssp, centers, 25, mesh)
    np.testing.assert_array_equal(a1, a2)
    np.testing.assert_allclose(
        np.asarray(c1), np.asarray(c2), rtol=1e-4, atol=1e-5
    )


def test_sharded_elkans_hybrid_matches_coo(hybrid_problem):
    """Elkan's on the factored-hybrid sharded layout (dense-head gather
    in the mini pass) agrees with the COO layout."""
    from isle_jax.elkans_sharded import sharded_run_elkans

    sp, ssp, h, mesh, (V, D) = hybrid_problem
    rng = np.random.default_rng(35)
    k = 4
    centers = jnp.asarray(rng.standard_normal((k, V)).astype(np.float32))
    c1, a1 = sharded_run_elkans(ssp, centers, 12, mesh)
    c2, a2 = sharded_run_elkans(h, centers, 12, mesh)
    np.testing.assert_array_equal(a1, a2)
    np.testing.assert_allclose(
        np.asarray(c1), np.asarray(c2), rtol=1e-3, atol=1e-4
    )


def test_mat_to_dense_sharded_layouts(problem, hybrid_problem):
    """Host densification of the sharded layouts (the dense-oracle
    eigensolver's input under mesh training) matches the single-device
    dense form, in global compact doc order."""
    from isle_jax.matops import mat_to_dense
    from isle_jax.sparse import to_dense

    sp, ssp, mesh, (w, d, v, V, D) = problem
    np.testing.assert_allclose(
        mat_to_dense(ssp), np.asarray(to_dense(sp)), rtol=1e-6, atol=1e-6
    )
    hsp, hssp, h, _, _ = hybrid_problem
    np.testing.assert_allclose(
        mat_to_dense(h), np.asarray(to_dense(hsp)), rtol=1e-2, atol=1e-3
    )  # bf16 head slab
    np.testing.assert_allclose(
        mat_to_dense(hssp), np.asarray(to_dense(hsp)), rtol=1e-6, atol=1e-6
    )
