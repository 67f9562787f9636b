"""Hybrid dense-head/sparse-tail layout must agree with the plain COO SpMM."""

import numpy as np
import pytest

from isle_jax.hybrid import h_b_y, h_bt_x, h_doc_l2sq, h_gram_x, to_hybrid
from isle_jax.sparse import DocSparse, b_y, bt_x, doc_l2sq, gram_x


def make(rng, V, D, density, zipf=True, chunk=512):
    probs = 1.0 / np.arange(1, V + 1) if zipf else np.ones(V)
    probs /= probs.sum()
    mask = rng.random((V, D)) < density * probs[:, None] * V
    w, d = np.nonzero(mask)
    order = np.lexsort((w, d))
    w, d = w[order], d[order]
    v = (rng.random(len(w)) * 3 + 0.5).astype(np.float32)
    return DocSparse.build(w, d, v, V, D, chunk=chunk), w, d, v


@pytest.mark.parametrize("seed,num_head", [(0, 8), (1, 1), (2, 25), (3, 60)])
def test_hybrid_matches_coo(seed, num_head):
    rng = np.random.default_rng(seed)
    V, D, W = 60, 45, 16
    sp, w, d, v = make(rng, V, D, 0.25)
    h = to_hybrid(sp, num_head, chunk=256)
    assert h.head_nnz + int((np.asarray(h.td_val) != 0).sum()) == sp.nnz

    X = rng.standard_normal((V, W)).astype(np.float32)
    Y = rng.standard_normal((D, W)).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(h_bt_x(h, X, 256)), np.asarray(bt_x(sp, X)), rtol=2e-5, atol=1e-4
    )
    np.testing.assert_allclose(
        np.asarray(h_b_y(h, Y, 256)), np.asarray(b_y(sp, Y)), rtol=2e-5, atol=1e-4
    )
    np.testing.assert_allclose(
        np.asarray(h_gram_x(h, X, 256)),
        np.asarray(gram_x(sp, X)),
        rtol=2e-4,
        atol=2e-3,
    )
    np.testing.assert_allclose(
        np.asarray(h_doc_l2sq(h, 256)), np.asarray(doc_l2sq(sp)), rtol=2e-5,
        atol=1e-4,
    )


def test_hybrid_all_head():
    # num_head == vocab: tail is empty padding
    rng = np.random.default_rng(5)
    V, D, W = 20, 30, 8
    sp, w, d, v = make(rng, V, D, 0.4, zipf=False)
    h = to_hybrid(sp, V, chunk=128)
    X = rng.standard_normal((V, W)).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(h_bt_x(h, X, 128)), np.asarray(bt_x(sp, X)), rtol=2e-5,
        atol=1e-4,
    )


def make_row_constant(rng, V, D, density, chunk=512):
    """Matrix whose row-w nonzeros all equal s[w] (the thresholded-B
    shape: every entry is sqrt(zeta_w))."""
    probs = 1.0 / np.arange(1, V + 1)
    probs /= probs.sum()
    mask = rng.random((V, D)) < density * probs[:, None] * V
    w, d = np.nonzero(mask)
    order = np.lexsort((w, d))
    w, d = w[order], d[order]
    s = np.sqrt(rng.integers(1, 9, V)).astype(np.float32)
    v = s[w]
    return DocSparse.build(w, d, v, V, D, chunk=chunk), s


@pytest.mark.parametrize("seed,num_head", [(0, 8), (1, 1), (2, 25), (3, 60)])
def test_factored_hybrid_matches_coo(seed, num_head):
    """Factored layout (bf16 binary head + valueless tail + row_scale)
    must reproduce the plain COO SpMM on a row-constant matrix."""
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    V, D, W = 60, 45, 16
    sp, s = make_row_constant(rng, V, D, 0.3)
    h = to_hybrid(sp, num_head, chunk=256, row_scale=jnp.asarray(s))
    assert h.td_val is None and h.tw_val is None
    assert h.head.dtype == jnp.bfloat16

    X = rng.standard_normal((V, W)).astype(np.float32)
    Y = rng.standard_normal((D, W)).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(h_bt_x(h, X, 256)), np.asarray(bt_x(sp, X)),
        rtol=2e-5, atol=1e-4,
    )
    np.testing.assert_allclose(
        np.asarray(h_b_y(h, Y, 256)), np.asarray(b_y(sp, Y)),
        rtol=2e-5, atol=1e-4,
    )
    np.testing.assert_allclose(
        np.asarray(h_gram_x(h, X, 256)), np.asarray(gram_x(sp, X)),
        rtol=2e-4, atol=2e-3,
    )
    np.testing.assert_allclose(
        np.asarray(h_doc_l2sq(h, 256)), np.asarray(doc_l2sq(sp)),
        rtol=2e-5, atol=1e-4,
    )


def test_factored_hybrid_to_dense_roundtrip():
    import jax.numpy as jnp

    from isle_jax.matops import mat_to_dense
    from isle_jax.sparse import to_dense

    rng = np.random.default_rng(7)
    V, D = 40, 30
    sp, s = make_row_constant(rng, V, D, 0.3, chunk=256)
    h = to_hybrid(sp, 10, chunk=256, row_scale=jnp.asarray(s))
    np.testing.assert_allclose(
        mat_to_dense(h), to_dense(sp), rtol=1e-6, atol=1e-6
    )


def test_fused_builder_matches_unfused():
    """hybrid_from_thresholds == threshold_and_copy -> to_hybrid(factored)
    on the same input (same original_cols, head selection, dense form)."""
    import jax
    import jax.numpy as jnp

    from isle_jax.bmatrix import threshold_and_copy
    from isle_jax.hybrid import hybrid_from_thresholds
    from isle_jax.matops import mat_to_dense

    rng = np.random.default_rng(11)
    V, D = 70, 90
    mask = rng.random((V, D)) < 0.3
    w, d = np.nonzero(mask)
    order = np.lexsort((w, d))
    w, d = w[order], d[order]
    v = rng.integers(1, 7, len(w)).astype(np.float32)
    sp = DocSparse.build(w, d, v, V, D, chunk=512)
    zetas = jnp.asarray(rng.integers(1, 4, V).astype(np.float32))

    B_ref, oc_ref = threshold_and_copy(sp, zetas, chunk=512)
    h_ref = to_hybrid(B_ref, 12, chunk=512, row_scale=jnp.sqrt(zetas))
    # budget chosen so the fused builder picks the same 12 head rows
    # (the no-sampling fused path budgets num_head from A.num_docs, the
    # pre-threshold doc count — see hybrid_from_thresholds)
    budget = 12 * 2 * D
    h, oc, frob = hybrid_from_thresholds(sp, zetas, budget, chunk=512)
    np.testing.assert_array_equal(oc, oc_ref)
    assert h.num_head == h_ref.num_head
    np.testing.assert_array_equal(
        np.asarray(h.head_words), np.asarray(h_ref.head_words)
    )
    assert h.nnz == B_ref.nnz and h.head_nnz == h_ref.head_nnz
    np.testing.assert_allclose(
        mat_to_dense(h), mat_to_dense(h_ref), rtol=1e-6, atol=1e-6
    )
    from isle_jax.sparse import frobenius_sq

    np.testing.assert_allclose(frob, float(frobenius_sq(B_ref)), rtol=1e-4)

    # sampled variant agrees too (same key => same pivot race)
    key = jax.random.PRNGKey(3)
    Bs, ocs = threshold_and_copy(sp, zetas, sample_rate=0.5, key=key, chunk=512)
    hs, ocs2, _ = hybrid_from_thresholds(
        sp, zetas, budget, chunk=512, sample_rate=0.5, key=key
    )
    np.testing.assert_array_equal(ocs, ocs2)
    hs_ref = to_hybrid(Bs, hs.num_head, chunk=512, row_scale=jnp.sqrt(zetas))
    np.testing.assert_allclose(
        mat_to_dense(hs), mat_to_dense(hs_ref), rtol=1e-6, atol=1e-6
    )


def test_blocked_head_scatter_matches_flat():
    """break_head_cap: a flat_cap small enough to force doc-blocked head
    scatters (hybrid._scatter_head) must reproduce the single-flat-
    scatter build exactly, in both general (f32 .add) and factored
    (bf16 binary) modes, and must lift num_head above the capped value."""
    import jax.numpy as jnp

    from isle_jax.matops import mat_to_dense

    rng = np.random.default_rng(21)
    V, D, num_head = 60, 45, 25
    sp, w, d, v = make(rng, V, D, 0.25)

    # flat_cap=400: cap = 400//46 - 1 = 7 (< 8, so the unbroken path
    # refuses), block = 400//26 - 1 = 14 -> 4 doc blocks for 45 docs.
    flat_cap = 400
    with pytest.raises(ValueError, match="flat-scatter"):
        to_hybrid(sp, num_head, chunk=256, flat_cap=flat_cap)

    ref = to_hybrid(sp, num_head, chunk=256)
    blk = to_hybrid(
        sp, num_head, chunk=256, break_head_cap=True, flat_cap=flat_cap
    )
    assert blk.num_head == ref.num_head == num_head
    np.testing.assert_array_equal(
        np.asarray(blk.head), np.asarray(ref.head)
    )
    np.testing.assert_allclose(
        mat_to_dense(blk), mat_to_dense(ref), rtol=0, atol=0
    )

    # factored mode
    spc, s = make_row_constant(rng, V, D, 0.3)
    rs = jnp.asarray(s)
    ref_f = to_hybrid(spc, num_head, chunk=256, row_scale=rs)
    blk_f = to_hybrid(
        spc, num_head, chunk=256, row_scale=rs,
        break_head_cap=True, flat_cap=flat_cap,
    )
    np.testing.assert_array_equal(
        np.asarray(blk_f.head, dtype=np.float32),
        np.asarray(ref_f.head, dtype=np.float32),
    )
    np.testing.assert_allclose(
        mat_to_dense(blk_f), mat_to_dense(ref_f), rtol=0, atol=0
    )


def test_fused_builder_break_head_cap():
    """hybrid_from_thresholds with break_head_cap under a small flat_cap
    (blocked head scatters in the fused single-sync program AND the
    sampled two-sync program) matches the default build exactly."""
    import jax
    import jax.numpy as jnp

    from isle_jax.hybrid import hybrid_from_thresholds
    from isle_jax.matops import mat_to_dense

    rng = np.random.default_rng(31)
    V, D = 70, 90
    mask = rng.random((V, D)) < 0.3
    w, d = np.nonzero(mask)
    order = np.lexsort((w, d))
    w, d = w[order], d[order]
    v = rng.integers(1, 7, len(w)).astype(np.float32)
    sp = DocSparse.build(w, d, v, V, D, chunk=512)
    zetas = jnp.asarray(rng.integers(1, 4, V).astype(np.float32))
    budget = 12 * 2 * D  # 12 head rows; cap at flat_cap=400 is 3 rows

    h_ref, oc_ref, frob_ref = hybrid_from_thresholds(
        sp, zetas, budget, chunk=512
    )
    h, oc, frob = hybrid_from_thresholds(
        sp, zetas, budget, chunk=512,
        break_head_cap=True, flat_cap=400,
    )
    assert h.num_head == h_ref.num_head == 12
    np.testing.assert_array_equal(oc, oc_ref)
    np.testing.assert_array_equal(
        np.asarray(h.head), np.asarray(h_ref.head)
    )
    np.testing.assert_allclose(
        mat_to_dense(h), mat_to_dense(h_ref), rtol=0, atol=0
    )
    np.testing.assert_allclose(frob, frob_ref, rtol=0)

    key = jax.random.PRNGKey(7)
    hs_ref, ocs_ref, _ = hybrid_from_thresholds(
        sp, zetas, budget, chunk=512, sample_rate=0.5, key=key
    )
    hs, ocs, _ = hybrid_from_thresholds(
        sp, zetas, budget, chunk=512, sample_rate=0.5, key=key,
        break_head_cap=True, flat_cap=400,
    )
    np.testing.assert_array_equal(ocs, ocs_ref)
    np.testing.assert_allclose(
        mat_to_dense(hs), mat_to_dense(hs_ref), rtol=0, atol=0
    )


def test_drop_sentinel_zetas_stay_finite():
    """zeta=+inf (the few_samples/bad_threshold drop sentinel) must not
    poison the factored layout: dropped words keep zero entries, and
    when the head budget selects them anyway (num_head reaching
    zero-count words), Xs = X * sqrt(zeta) would carry an inf row and
    0 * inf = NaN through every head product. row_scale_from_zetas
    neutralizes the sentinel to 0 (round-4 review finding)."""
    import jax.numpy as jnp

    from isle_jax.hybrid import h_gram_x, hybrid_from_thresholds
    from isle_jax.matops import mat_to_dense

    rng = np.random.default_rng(17)
    V, D = 32, 40
    mask = rng.random((V, D)) < 0.4
    w, d = np.nonzero(mask)
    order = np.lexsort((w, d))
    w, d = w[order], d[order]
    v = rng.integers(1, 6, len(w)).astype(np.float32)
    sp = DocSparse.build(w, d, v, V, D, chunk=256)
    zetas = np.full(V, 2.0, np.float32)
    zetas[3] = np.inf  # dropped word
    zetas[7] = np.inf

    # head budget >= V rows: the dropped (zero-kept) words enter the head
    h, oc, frob = hybrid_from_thresholds(
        sp, jnp.asarray(zetas), V * 2 * D, chunk=256
    )
    assert np.isfinite(np.asarray(h.row_scale)).all()
    dense = mat_to_dense(h)
    assert np.isfinite(dense).all()
    assert (dense[3] == 0).all() and (dense[7] == 0).all()
    X = rng.standard_normal((V, 8)).astype(np.float32)
    assert np.isfinite(np.asarray(h_gram_x(h, X, 256))).all()


def test_split_bf16x3_reconstructs_f32():
    """The head dot's operand split: every piece is exactly representable
    in bf16 and the pieces sum back to the f32 input to ~2^-24."""
    import jax.numpy as jnp

    from isle_jax.hybrid import _split_bf16x3

    rng = np.random.default_rng(0)
    x = (rng.standard_normal((64, 5)) * 10.0 ** rng.integers(-6, 6, (64, 5))
         ).astype(np.float32)
    parts = np.asarray(_split_bf16x3(jnp.asarray(x)).astype(jnp.float32),
                       np.float64)
    recon = parts[:, :5] + parts[:, 5:10] + parts[:, 10:]
    np.testing.assert_allclose(recon, x, rtol=2.0 ** -22, atol=0)
    assert np.abs(parts[:, 5:10]).max() > 0  # mid piece carries bits
