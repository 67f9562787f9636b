"""k-means++ seeding and Lloyd's, projected and full-space."""

import jax
import jax.numpy as jnp
import numpy as np

from isle_jax.kmeans import (
    kmeans_init_on_projected,
    kmeanspp_on_projected,
    run_lloyds_full,
    run_lloyds_projected,
)
from isle_jax.sparse import DocSparse, to_dense


def clustered_projected(rng, kdim, k, per):
    mus = rng.standard_normal((k, kdim)) * 10
    pts = np.concatenate(
        [mus[i] + 0.1 * rng.standard_normal((per, kdim)) for i in range(k)]
    )
    return np.asarray(pts.T, np.float32)  # (kdim, D)


def test_kmeanspp_unique_and_count():
    rng = np.random.default_rng(0)
    P = clustered_projected(rng, 6, 8, 40)
    centers, residual = kmeanspp_on_projected(jnp.asarray(P), 8, jax.random.PRNGKey(0))
    c = np.asarray(centers)
    assert len(np.unique(c)) == 8
    assert (c >= 0).all() and (c < P.shape[1]).all()
    assert residual >= 0.0


def test_kmeanspp_spreads_over_clusters():
    # With tight well-separated clusters, D^2 sampling picks one per cluster.
    rng = np.random.default_rng(1)
    k, per = 6, 50
    P = clustered_projected(rng, 4, k, per)
    centers, _ = kmeanspp_on_projected(jnp.asarray(P), k, jax.random.PRNGKey(3))
    picked_clusters = np.asarray(centers) // per
    assert len(np.unique(picked_clusters)) == k


def test_lloyds_projected_recovers_clusters():
    rng = np.random.default_rng(2)
    k, per = 5, 30
    P = clustered_projected(rng, 5, k, per)
    Pj = jnp.asarray(P)
    _, centers0, _ = kmeans_init_on_projected(Pj, k, 1, jax.random.PRNGKey(0))
    centers, assign = run_lloyds_projected(Pj, centers0, 10)
    a = np.asarray(assign)
    # each true cluster maps to exactly one label
    for i in range(k):
        assert len(np.unique(a[i * per : (i + 1) * per])) == 1
    assert len(np.unique(a)) == k


def test_lloyds_full_space():
    rng = np.random.default_rng(3)
    V, D, k = 40, 120, 3
    # three disjoint word blocks
    w_list, d_list, v_list = [], [], []
    for d in range(D):
        block = d % k
        ws = rng.choice(np.arange(block * 13, block * 13 + 13), 5, replace=False)
        for w in np.sort(ws):
            w_list.append(w)
            d_list.append(d)
            v_list.append(rng.integers(1, 4))
    sp = DocSparse.build(
        np.array(w_list), np.array(d_list), np.array(v_list, np.float32), V, D,
        chunk=1024, doc_sorted=True,
    )
    centers0 = jnp.asarray(to_dense(sp)[:, :k].T)  # seed with first docs
    centers, assign = run_lloyds_full(sp, centers0, 10)
    a = np.asarray(assign)
    for blk in range(k):
        assert len(np.unique(a[blk::k])) == 1
    assert len(np.unique(a)) == k


def test_empty_cluster_center_is_zero():
    rng = np.random.default_rng(4)
    P = jnp.asarray(rng.standard_normal((3, 20)).astype(np.float32))
    # Far-away center never wins
    centers0 = jnp.concatenate(
        [jnp.asarray(P[:, :2].T), jnp.full((1, 3), 1e6, jnp.float32)]
    )
    # one iteration: the far center gets no docs -> zero vector
    # (further reps may legitimately assign docs to the origin)
    centers, assign = run_lloyds_projected(P, centers0, 1)
    assert (np.asarray(centers)[2] == 0).all()


def test_mcmc_chain_matches_literal_oracle():
    """Device Metropolis chain (_mcmc_chain_step's fori_loop recurrence)
    vs the sequential oracle, on the same dmin/q/u inputs."""
    import jax
    import jax.numpy as jnp

    from isle_jax.kmeans import mcmc_chain_literal

    rng = np.random.default_rng(0)
    S = 257
    dmin = rng.random(S).astype(np.float32)
    dmin[rng.random(S) < 0.1] = 0.0  # exercise the denom == 0 branch
    q_s = (rng.random(S).astype(np.float32) + 0.01)
    u = rng.random(S).astype(np.float32)

    want = mcmc_chain_literal(dmin, q_s, u)

    dmin_j = jnp.asarray(dmin)
    q_j = jnp.asarray(q_s)
    u_j = jnp.asarray(u)

    def body(s, cur):
        denom = dmin_j[cur] * q_j[s]
        ratio = jnp.where(denom > 0.0, (dmin_j[s] * q_j[cur]) / denom, 1.0)
        return jnp.where(ratio > u_j[s], s, cur)

    got = int(jax.lax.fori_loop(1, S, body, jnp.int32(0)))
    assert got == want


def test_kmeansmcmc_usable_at_larger_k():
    """The vectorized chain makes k in the hundreds practical (the host
    loop was 10k interpreter iterations per center)."""
    import time

    import jax

    from isle_jax.kmeans import kmeansmcmc_on_projected

    rng = np.random.default_rng(1)
    P = jnp.asarray(rng.standard_normal((8, 4000)).astype(np.float32))
    t0 = time.perf_counter()
    idx, centers, residual = kmeansmcmc_on_projected(
        P, 64, jax.random.PRNGKey(0), sample_size=512
    )
    dt = time.perf_counter() - t0
    assert centers.shape == (64, 8)
    assert len(np.unique(np.asarray(idx))) > 32
    assert residual > 0


def test_kmeanspp_terminates_when_points_exhausted():
    """k > #distinct docs: once every distinct point is a center the D^2
    mass is zero and the on-device while_loop used to spin forever
    (round-4 review). The guard fills the remaining slots
    deterministically and terminates; duplicates are the degenerate
    answer."""
    import jax

    from isle_jax.kmeans import kmeanspp_on_projected

    P = jnp.asarray(
        np.repeat(np.eye(3, dtype=np.float32), 4, axis=1)
    )  # 12 docs, only 3 distinct points
    centers, residual = kmeanspp_on_projected(P, 6, jax.random.PRNGKey(0))
    c = np.asarray(centers)
    assert c.shape == (6,)
    assert ((c >= 0) & (c < 12)).all()
    assert residual == 0.0 or residual >= 0.0
