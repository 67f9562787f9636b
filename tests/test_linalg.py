"""Block-KS eigensolver vs the dense LAPACK oracle (the reference's own
validation pattern, src/denseMatrix.cpp:413-461)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from isle_jax.linalg import align_signs, block_ks, dense_topk_eigh
from isle_jax.sparse import DocSparse, gram_x, to_dense


def spd_op(S):
    Sj = jnp.asarray(S)

    def op(X):
        return jnp.matmul(Sj, X, precision=jax.lax.Precision.HIGHEST)

    return op


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("nev,blk", [(5, 4), (10, 8), (7, 16)])
def test_dense_operator(seed, nev, blk):
    rng = np.random.default_rng(seed)
    dim = 120
    A = rng.standard_normal((dim, dim // 2)).astype(np.float32)
    S = (A @ A.T).astype(np.float32)
    res = block_ks(
        spd_op(S), dim, nev, blk=blk, tol=1e-5, key=jax.random.PRNGKey(seed)
    )
    w_ref, v_ref = dense_topk_eigh(S, nev)
    assert res.nconv == nev
    np.testing.assert_allclose(res.evals, w_ref, rtol=1e-4)
    U = align_signs(np.asarray(res.evecs), v_ref.astype(np.float32))
    # eigenvector agreement up to sign, looser where eigvalues cluster
    gaps = np.abs(np.diff(w_ref))
    ok_cols = np.ones(nev, bool)
    ok_cols[1:] &= gaps > 1e-3 * w_ref[0]
    ok_cols[:-1] &= gaps > 1e-3 * w_ref[0]
    np.testing.assert_allclose(
        U[:, ok_cols], v_ref[:, ok_cols], atol=5e-3
    )


def test_sparse_gram_operator():
    rng = np.random.default_rng(7)
    V, D = 150, 400
    mask = rng.random((V, D)) < 0.08
    w, d = np.nonzero(mask)
    order = np.lexsort((w, d))
    v = (rng.integers(1, 4, len(w))).astype(np.float32)
    sp = DocSparse.build(w[order], d[order], v[order], V, D, chunk=2048)
    nev = 8
    res = block_ks(
        lambda X: gram_x(sp, X), V, nev, blk=8, tol=1e-5, key=jax.random.PRNGKey(0)
    )
    Bd = to_dense(sp).astype(np.float64)
    w_ref, v_ref = dense_topk_eigh(Bd @ Bd.T, nev)
    np.testing.assert_allclose(res.evals, w_ref, rtol=1e-3)
    # residual check: ||S u - lambda u|| / lambda small
    U = np.asarray(res.evecs).astype(np.float64)
    S = Bd @ Bd.T
    resid = np.linalg.norm(S @ U - U * res.evals[None, :], axis=0) / res.evals
    # fp32 Arnoldi: the residual estimate is accurate to ~eps*lambda_max, so
    # the smallest kept eigenpair sees a few-e-3 true relative residual.
    assert resid.max() < 5e-3


def test_restart_path():
    # Force restarts with slowly decaying spectrum and tiny Krylov space.
    rng = np.random.default_rng(2)
    dim = 200
    Q, _ = np.linalg.qr(rng.standard_normal((dim, dim)))
    evals = 1.0 / np.arange(1, dim + 1) ** 0.25
    S = (Q * evals) @ Q.T
    res = block_ks(
        spd_op(S.astype(np.float32)),
        dim,
        nev=6,
        blk=2,
        steps_per_restart=2,
        tol=1e-4,
        key=jax.random.PRNGKey(1),
    )
    assert res.restarts > 0
    w_ref, _ = dense_topk_eigh(S, 6)
    np.testing.assert_allclose(res.evals, w_ref, rtol=1e-3)


def test_device_loop_matches_host_loop():
    from isle_jax.linalg import block_ks_device

    rng = np.random.default_rng(3)
    dim = 150
    A = rng.standard_normal((dim, 70)).astype(np.float32)
    S = (A @ A.T).astype(np.float32)
    nev = 6
    r1 = block_ks(spd_op(S), dim, nev, blk=4, tol=1e-5, key=jax.random.PRNGKey(2))
    r2 = block_ks_device(
        spd_op(S), dim, nev, blk=4, tol=1e-5, key=jax.random.PRNGKey(2)
    )
    assert r2.nconv == nev
    np.testing.assert_allclose(r2.evals, r1.evals, rtol=1e-4)
    w_ref, _ = dense_topk_eigh(S, nev)
    np.testing.assert_allclose(r2.evals, w_ref, rtol=1e-4)


def test_lanczos_matches_dense_oracle():
    """The second iterative solver (thick-restart Lanczos, the Spectra
    analog src/sparseMatrix.cpp:1161-1192) vs the LAPACK oracle."""
    from isle_jax.linalg import lanczos_device

    rng = np.random.default_rng(2)
    dim = 120
    A = rng.standard_normal((dim, dim // 2)).astype(np.float32)
    S = (A @ A.T).astype(np.float32)
    nev = 6
    res = lanczos_device(
        spd_op(S), dim, nev, tol=1e-5, key=jax.random.PRNGKey(1)
    )
    w_ref, v_ref = dense_topk_eigh(S, nev)
    assert res.nconv == nev
    np.testing.assert_allclose(res.evals, w_ref, rtol=1e-4)
    U = align_signs(np.asarray(res.evecs), v_ref.astype(np.float32))
    gaps = np.abs(np.diff(w_ref))
    ok = np.ones(nev, bool)
    ok[1:] &= gaps > 1e-3 * w_ref[0]
    ok[:-1] &= gaps > 1e-3 * w_ref[0]
    np.testing.assert_allclose(U[:, ok], v_ref[:, ok], atol=5e-3)


def test_lanczos_cross_checks_block_ks_on_gram():
    """Mutual cross-check on the pipeline's B B^T operator: the two
    independent solvers must agree to the configured tolerance (the
    reference's BlockKs-vs-Spectra discipline)."""
    from isle_jax.linalg import block_ks_device, lanczos_device

    rng = np.random.default_rng(8)
    V, D = 150, 500
    mask = rng.random((V, D)) < 0.08
    w, d = np.nonzero(mask)
    order = np.lexsort((w, d))
    v = (rng.integers(1, 4, len(w))).astype(np.float32)
    sp = DocSparse.build(w[order], d[order], v[order], V, D, chunk=2048)
    nev = 8
    op = lambda data, X: gram_x(data, X)
    a = block_ks_device(
        op, V, nev, op_data=sp, blk=8, tol=1e-5, key=jax.random.PRNGKey(0)
    )
    b = lanczos_device(
        op, V, nev, op_data=sp, tol=1e-5, key=jax.random.PRNGKey(3)
    )
    np.testing.assert_allclose(a.evals, b.evals, rtol=1e-4)


def test_trainer_lanczos_eigensolver_option():
    """eigensolver="lanczos" is selectable end-to-end and reproduces the
    block_ks model."""
    import dataclasses

    from isle_jax.config import HyperParams, TrainConfig
    from isle_jax.corpus import Corpus
    from isle_jax.trainer import Trainer
    import tempfile

    rng = np.random.default_rng(6)
    V, D, k = 80, 240, 4
    block = V // k
    docs, words, counts = [], [], []
    for d in range(D):
        t = rng.integers(0, k)
        ws = np.concatenate(
            [rng.integers(t * block, (t + 1) * block, 16),
             rng.integers(0, V, 3)]
        )
        ws, cs = np.unique(ws, return_counts=True)
        docs.append(np.full(len(ws), d))
        words.append(ws)
        counts.append(cs)
    corpus = Corpus.from_entries(
        np.concatenate(docs), np.concatenate(words), np.concatenate(counts),
        vocab_size=V, num_docs=D, sort_dedup=True,
    )

    def run(eig):
        cfg = TrainConfig(
            num_topics=k, seed=0,
            hyper=HyperParams(block_ks_block_size=8, eigensolver=eig),
        )
        with tempfile.TemporaryDirectory() as tmp:
            tr = Trainer(cfg, output_dir=tmp, quiet=True)
            tr.corpus = corpus
            tr._post_ingest()
            tr.train()
        return tr

    a = run("block_ks")
    b = run("lanczos")
    np.testing.assert_allclose(a.evalues, b.evalues, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(a.model, b.model, rtol=1e-3, atol=1e-5)


# ---------------------------------------------------------------------------
# Rank-deficiency hardening (round-4 VERDICT item 4): the reference detects
# Krylov-block rank collapse and refills with random directions
# (block-ks/restarted_block_ks.h:106-132, ks_utils.h:43-127). Here the
# absorbed-DGKS QR supplies null-space directions and the convergence test
# switches to an absolute criterion for numerically-zero Ritz values
# (linalg.RANK_TOL): nev > rank terminates with nconv == nev, exact-zero
# tail eigenvalues, and an orthonormal basis whose tail columns span the
# null space.
# ---------------------------------------------------------------------------


def _low_rank_op():
    import jax

    def op(data, X):
        HI = jax.lax.Precision.HIGHEST
        return jnp.matmul(
            data, jnp.matmul(data.T, X, precision=HI), precision=HI
        )

    return op


@pytest.mark.parametrize("solver_name", ["block_ks", "block_ks_device",
                                         "lanczos"])
@pytest.mark.parametrize("rank,nev", [(6, 10), (3, 8)])
def test_rank_deficient_operator(solver_name, rank, nev):
    from isle_jax.linalg import block_ks_device, lanczos_device

    rng = np.random.default_rng(rank)
    dim = 300
    B = jnp.asarray(rng.normal(size=(dim, rank)), jnp.float32)
    w_ref, _ = dense_topk_eigh(np.asarray(B @ B.T, np.float64), nev)
    solver, kw = {
        "block_ks": (block_ks, dict(blk=8)),
        "block_ks_device": (block_ks_device, dict(blk=8)),
        "lanczos": (lanczos_device, {}),
    }[solver_name]
    res = solver(_low_rank_op(), dim, nev, op_data=B, tol=1e-4,
                 max_restarts=12, key=jax.random.PRNGKey(0), **kw)
    assert res.nconv == nev
    # exact-zero tail evals (documented clamp), accurate leading evals
    np.testing.assert_array_equal(res.evals[rank:], 0.0)
    np.testing.assert_allclose(res.evals[:rank], w_ref[:rank],
                               rtol=1e-4)
    # the returned basis stays orthonormal (the historical failure mode:
    # lanczos normalized rounding noise and blew the basis up ~200x)
    E = np.asarray(res.evecs, np.float64)
    assert np.abs(E.T @ E - np.eye(nev)).max() < 1e-5
    # tail columns are genuine null-space eigenvectors: S u ~ 0
    S = np.asarray(B @ B.T, np.float64)
    tail_resid = np.linalg.norm(S @ E[:, rank:], axis=0)
    assert tail_resid.max() < 1e-3 * w_ref[0]


@pytest.mark.parametrize("solver_name", ["block_ks", "block_ks_device",
                                         "lanczos"])
def test_repeated_leading_eigenvalue(solver_name):
    """5-fold degenerate leading eigenvalue (duplicate-doc corpora produce
    exactly this)."""
    from isle_jax.linalg import block_ks_device, lanczos_device

    rng = np.random.default_rng(42)
    dim, nev = 200, 8
    Q, _ = np.linalg.qr(rng.normal(size=(dim, dim)))
    lam = np.concatenate(
        [np.full(5, 5.0), [1.0, 0.5, 0.25], np.full(dim - 8, 0.01)]
    )
    B = jnp.asarray(Q * np.sqrt(lam), jnp.float32)  # S = B B^T
    w_ref, _ = dense_topk_eigh(np.asarray(B @ B.T, np.float64), nev)
    solver, kw = {
        "block_ks": (block_ks, dict(blk=8)),
        "block_ks_device": (block_ks_device, dict(blk=8)),
        "lanczos": (lanczos_device, {}),
    }[solver_name]
    res = solver(_low_rank_op(), dim, nev, op_data=B, tol=1e-4,
                 max_restarts=30, key=jax.random.PRNGKey(1), **kw)
    assert res.nconv == nev
    np.testing.assert_allclose(res.evals, w_ref, rtol=1e-4)


def test_duplicate_doc_corpus_gram():
    """A corpus whose docs are copies of 4 distinct docs: B B^T has rank
    <= 4; ask for nev=6 through the real sparse Gram operator."""
    rng = np.random.default_rng(3)
    V, n_distinct, copies = 80, 4, 30
    D = n_distinct * copies
    ws, ds, vs = [], [], []
    for proto in range(n_distinct):
        w_p = np.sort(rng.choice(V, 12, replace=False))
        v_p = rng.integers(1, 5, 12).astype(np.float32)
        for c in range(copies):
            d_id = proto * copies + c
            ws.append(w_p)
            ds.append(np.full(12, d_id))
            vs.append(v_p)
    w = np.concatenate(ws)
    d = np.concatenate(ds)
    v = np.concatenate(vs)
    order = np.lexsort((w, d))
    sp = DocSparse.build(w[order], d[order], v[order], V, D, chunk=1024)
    nev = 6
    res = block_ks(
        lambda X: gram_x(sp, X), V, nev, blk=8, tol=1e-4,
        key=jax.random.PRNGKey(0), max_restarts=12,
    )
    Bd = to_dense(sp).astype(np.float64)
    w_ref, _ = dense_topk_eigh(Bd @ Bd.T, nev)
    assert res.nconv == nev
    np.testing.assert_allclose(
        res.evals[:n_distinct], w_ref[:n_distinct], rtol=1e-4
    )
    np.testing.assert_array_equal(res.evals[n_distinct:], 0.0)


def test_warm_start_block_cuts_op_calls():
    """Restart-warm eigen: seeding with the true eigenvectors converges
    in the first pass with the same spectrum (linalg._init_block)."""
    from isle_jax.linalg import block_ks_device

    rng = np.random.default_rng(5)
    dim, nev = 400, 12
    B = jnp.asarray(rng.normal(size=(dim, 64)) *
                    np.exp(-np.arange(64) / 8.0), jnp.float32)
    w_ref, U_ref = dense_topk_eigh(np.asarray(B @ B.T, np.float64), nev)
    # blk >= nev so the whole previous basis fits the start block (the
    # pipeline case: blk=128 >= k=100)
    cold = block_ks_device(_low_rank_op(), dim, nev, op_data=B, blk=16,
                           tol=1e-5, key=jax.random.PRNGKey(0))
    warm = block_ks_device(_low_rank_op(), dim, nev, op_data=B, blk=16,
                           tol=1e-5, key=jax.random.PRNGKey(0),
                           start_block=jnp.asarray(U_ref, jnp.float32))
    assert warm.nconv == nev
    np.testing.assert_allclose(warm.evals, w_ref, rtol=1e-4)
    assert warm.restarts <= cold.restarts
    assert warm.restarts == 0
