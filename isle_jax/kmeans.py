"""k-means machinery: D^2 (k-means++) seeding on the projected docs and
Lloyd's iterations on the projected space and on the full vocab space.

Reference semantics:
  - kmeanspp_on_projected_space (src/sparseMatrix.cpp:2133-2209): first
    center uniformly random; per round, up to 1 + sqrt(max(s-5, 0)) new
    centers are drawn from the D^2 distribution WITHOUT refreshing min-dist
    between draws (batched addition, :2183); duplicates are rejected;
    min-dist refreshes once per round against the previous round's batch;
    distances are clamped at zero (:2116-2125).
  - lloyds_iter_on_projected_space (:1920-2013) / lloyds_iter (:1586-1677):
    distances via ||x||^2 + ||c||^2 - 2 x.c with gemm/SpMM; assignment by
    first-index argmin (FPimin); centroid = cluster mean, zero vector for
    empty clusters; convergence = unchanged memberships, capped reps.

Device design: the projected matrix P = U^T B (num_topics x docs) is
materialized once (it is tiny in device-memory terms — k * docs floats),
so seeding and projected Lloyd's are pure dense matmul work; full-space Lloyd's uses the
SpMM primitives with dense (k x vocab) centers. The whole k-means++ loop
runs on device inside one lax.while_loop.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .matops import mat_b_y, mat_bt_x, mat_doc_l2sq
from .sparse import DocSparse

HI = jax.lax.Precision.HIGHEST


# ---------------------------------------------------------------------------
# k-means++ on the projected space
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("k", "nb_max"))
def _kmeanspp_loop(P: jax.Array, key: jax.Array, k: int, nb_max: int):
    """P: (kdim, D) projected docs. Returns (center doc ids (k,), residual)."""
    kdim, D = P.shape
    docs_l2 = jnp.sum(P * P, axis=0)

    key, sub = jax.random.split(key)
    first = jax.random.randint(sub, (), 0, D)

    min_dist = jnp.full((D,), jnp.finfo(jnp.float32).max, jnp.float32)
    chosen = jnp.zeros((D,), bool).at[first].set(True)
    centers = jnp.zeros((k,), jnp.int32).at[0].set(first.astype(jnp.int32))
    # slots filled in the previous round (refresh set), padded with -1
    fresh = jnp.full((nb_max,), -1, jnp.int32).at[0].set(first.astype(jnp.int32))

    def cond(state):
        _, _, _, _, count, _, _ = state
        return count < k

    def body(state):
        key, min_dist, chosen, centers, count, fresh, _ = state
        # Refresh min-dist against the previous round's fresh centers.
        valid = fresh >= 0
        idx = jnp.maximum(fresh, 0)
        C = P[:, idx]  # (kdim, nb_max)
        c_l2 = jnp.sum(C * C, axis=0)
        dots = jnp.einsum("kd,kc->dc", P, C, precision=HI)
        dists = docs_l2[:, None] + c_l2[None, :] - 2.0 * dots
        dists = jnp.maximum(dists, 0.0)
        dists = jnp.where(valid[None, :], dists, jnp.inf)
        min_dist = jnp.minimum(min_dist, jnp.min(dists, axis=1))

        cumul = jnp.cumsum(min_dist)
        total = cumul[-1]
        # Exhaustion guard: once every distinct point is a chosen center
        # (duplicate-doc corpora with k > #distinct docs), min_dist is
        # all-zero, every draw lands on an already-chosen doc, and the
        # while_loop would spin forever ON DEVICE with no host interrupt.
        # Fill the remaining slots deterministically (cycling from the
        # first center) and finish — duplicate centers are the honest
        # degenerate answer; Lloyd's then leaves the extra clusters
        # empty. The reference would spin here too; terminating is ours.
        exhausted = total <= 0.0
        slots = jnp.arange(k, dtype=jnp.int32)
        fill_ids = (centers[0] + slots) % jnp.int32(D)
        centers = jnp.where(
            exhausted, jnp.where(slots < count, centers, fill_ids), centers
        )
        count = jnp.where(exhausted, jnp.int32(k), count)
        s = count
        # Candidate draws this round: the reference's loop runs while
        # c < 1 + sqrt(max(s-5, 0)) with a FLOAT bound
        # (src/sparseMatrix.cpp:2183), i.e. ceil(1 + sqrt(.)) iterations.
        nb = jnp.ceil(
            1.0 + jnp.sqrt(jnp.maximum(s - 5, 0).astype(jnp.float32))
        ).astype(jnp.int32)

        key, sub = jax.random.split(key)
        dice = jax.random.uniform(sub, (nb_max,), jnp.float32) * total
        new_fresh = jnp.full((nb_max,), -1, jnp.int32)

        def draw(i, carry):
            chosen, centers, count, new_fresh = carry
            cand = jnp.searchsorted(cumul, dice[i], side="right").astype(jnp.int32)
            cand = jnp.minimum(cand, D - 1)
            ok = (i < nb) & (count < k) & (~chosen[cand])
            chosen = chosen.at[cand].set(chosen[cand] | ok)
            centers = jnp.where(
                ok, centers.at[count].set(cand), centers
            )
            new_fresh = jnp.where(ok, new_fresh.at[i].set(cand), new_fresh)
            count = count + ok.astype(count.dtype)
            return chosen, centers, count, new_fresh

        chosen, centers, count, new_fresh = jax.lax.fori_loop(
            0, nb_max, draw, (chosen, centers, count, new_fresh)
        )
        return key, min_dist, chosen, centers, count, new_fresh, total

    state = (key, min_dist, chosen, centers, jnp.int32(1), fresh, jnp.float32(0))
    key, min_dist, chosen, centers, count, fresh, _ = jax.lax.while_loop(
        cond, body, state
    )
    # Residual as the reference reports it: cumulative min-dist through the
    # second-to-last doc (src/sparseMatrix.cpp:2207 reads dist_cumul[D-1]).
    residual = jnp.cumsum(min_dist)[-2] if P.shape[1] > 1 else jnp.float32(0)
    return centers, residual


def kmeanspp_on_projected(
    P: jax.Array, k: int, key: jax.Array
) -> Tuple[jax.Array, float]:
    nb_max = 1 + int(math.ceil(math.sqrt(max(k - 5, 1)))) + 1
    centers, residual = _kmeanspp_loop(P, key, k, nb_max)
    return centers, float(residual)


def kmeans_init_on_projected(
    P: jax.Array,
    k: int,
    reps: int,
    key: jax.Array,
    method: str = "kmeanspp",
    timer=None,
    mcmc_sample_size: int = 10000,
) -> Tuple[Optional[jax.Array], jax.Array, float]:
    """Best-of-`reps` seeding with the configured method
    (kmeans_init_on_projected_space src/sparseMatrix.cpp:2212-2238;
    FPDenseMatrix::kmeans_init src/denseMatrix.cpp:885-932). Returns
    (seed doc ids or None for kmeansbb, centers (k, kdim), residual)."""
    best = None
    for rep in range(reps):
        key, sub = jax.random.split(key)
        if method == "kmeansbb":
            centers, residual = kmeansbb_on_projected(P, k, sub, timer=timer)
            idx = None
        elif method == "kmeansmcmc":
            idx, centers, residual = kmeansmcmc_on_projected(
                P, k, sub, sample_size=mcmc_sample_size, timer=timer
            )
        else:
            idx, residual = kmeanspp_on_projected(P, k, sub)
            centers = P[:, idx].T
        if best is None or residual < best[2]:
            best = (idx, centers, residual)
    return best


# ---------------------------------------------------------------------------
# Alternative seedings: k-means|| (KMEANSBB) and AFK-MC^2 (KMEANSMCMC)
# ---------------------------------------------------------------------------


def kmeansbb_on_projected(
    P: jax.Array, k: int, key: jax.Array, timer=None
) -> Tuple[jax.Array, float]:
    """k-means|| oversampling init (reference FPDenseMatrix::kmeansbb,
    src/denseMatrix.cpp:681-783): R = 10 + 5 ln k rounds; per round every
    doc independently becomes a candidate with prob L*min_dist/total,
    L = k/2; candidates are weighted by their cluster sizes and reduced to
    k centers by weighted Lloyd's.

    Deviations from the reference, both documented bugs there: candidate
    coordinates are the sampled docs (the reference copies the first
    |candidates| columns instead, :749-752), and the final weighted Lloyd's
    starts from weighted-D^2 seeds rather than uninitialized memory
    (:776-777)."""
    kdim, D = P.shape
    L = max(int(0.5 * k), 1)
    R = 10 + 5 * int(math.log(max(k, 2)))
    docs_l2 = jnp.sum(P * P, axis=0)

    key, sub = jax.random.split(key)
    first = int(jax.random.randint(sub, (), 0, D))
    cand = [first]
    min_dist = jnp.maximum(
        docs_l2 + docs_l2[first]
        - 2.0 * jnp.einsum("kd,k->d", P, P[:, first], precision=HI),
        0.0
    )
    for _ in range(R):
        total = float(jnp.sum(min_dist))
        if total <= 0:
            break
        key, sub = jax.random.split(key)
        u = jax.random.uniform(sub, (D,))
        newly = np.flatnonzero(np.asarray(u < L * min_dist / total))
        if len(newly) == 0:
            continue
        cand.extend(int(x) for x in newly)
        C = P[:, newly]
        dists = (
            docs_l2[:, None]
            + jnp.sum(C * C, axis=0)[None, :]
            - 2.0 * jnp.einsum("kd,kc->dc", P, C, precision=HI)
        )
        min_dist = jnp.minimum(min_dist, jnp.maximum(jnp.min(dists, axis=1), 0.0))
    cand = sorted(set(cand))
    Pc = P[:, jnp.asarray(np.array(cand))]  # (kdim, C)

    # weight candidates by #docs closest to them
    dists = (
        docs_l2[:, None]
        + jnp.sum(Pc * Pc, axis=0)[None, :]
        - 2.0 * jnp.einsum("kd,kc->dc", P, Pc, precision=HI)
    )
    closest = jnp.argmin(dists, axis=1)
    weights = jax.ops.segment_sum(
        jnp.ones((D,), jnp.float32), closest, num_segments=len(cand)
    )

    # weighted D^2 seeding + weighted Lloyd's on candidates
    key, sub = jax.random.split(key)
    centers = _weighted_kmeanspp(Pc, weights, k, sub)
    centers, residual = _weighted_lloyds(Pc, weights, centers, reps=10)
    if timer is not None:
        timer.diag(f"kmeansbb: {len(cand)} candidates -> {k} centers")
    return centers, float(residual)


def _weighted_kmeanspp(P, w, k, key):
    kdim, D = P.shape
    docs_l2 = jnp.sum(P * P, axis=0)
    key, sub = jax.random.split(key)
    first = jax.random.categorical(sub, jnp.log(jnp.maximum(w, 1e-30)))
    idx = [int(first)]
    min_dist = jnp.maximum(
        docs_l2 + docs_l2[first]
        - 2.0 * jnp.einsum("kd,k->d", P, P[:, first], precision=HI),
        0.0,
    )
    for _ in range(1, k):
        key, sub = jax.random.split(key)
        logits = jnp.log(jnp.maximum(min_dist * w, 1e-30))
        nxt = int(jax.random.categorical(sub, logits))
        idx.append(nxt)
        d = jnp.maximum(
            docs_l2 + docs_l2[nxt]
            - 2.0 * jnp.einsum("kd,k->d", P, P[:, nxt], precision=HI),
            0.0,
        )
        min_dist = jnp.minimum(min_dist, d)
    return P[:, jnp.asarray(np.array(idx))].T  # (k, kdim)


def _weighted_lloyds(P, w, centers, reps):
    docs_l2 = jnp.sum(P * P, axis=0)
    k = centers.shape[0]
    residual = jnp.float32(0)
    for _ in range(reps):
        c_l2 = jnp.sum(centers * centers, axis=1)
        dists = (
            docs_l2[:, None]
            + c_l2[None, :]
            - 2.0 * jnp.einsum("kd,ck->dc", P, centers, precision=HI)
        )
        assign = jnp.argmin(dists, axis=1)
        residual = jnp.sum(jnp.maximum(jnp.min(dists, axis=1), 0.0) * w)
        sums = jax.ops.segment_sum((P * w[None, :]).T, assign, num_segments=k)
        counts = jax.ops.segment_sum(w, assign, num_segments=k)
        centers = jnp.where(counts[:, None] > 0, sums / counts[:, None], 0.0)
    return centers, residual


@partial(jax.jit, static_argnames=("sample_size",))
def _mcmc_chain_step(
    P: jax.Array,  # (kdim, D)
    q: jax.Array,  # (D,) proposal distribution
    centers_idx: jax.Array,  # (k,) current center doc ids (padded with 0)
    n_centers: jax.Array,  # scalar: how many slots are live
    key: jax.Array,
    sample_size: int,
):
    """One Metropolis chain over a `sample_size` proposal batch, fully on
    device: draw the batch from q, compute its exact min-dists to the live
    centers, then run the sequential accept/reject recurrence as a
    lax.fori_loop carrying only the current chain index. Returns the
    accepted doc id."""
    k = centers_idx.shape[0]
    s1, s2 = jax.random.split(key)
    samp = jax.random.categorical(s1, jnp.log(q), shape=(sample_size,))
    Cs = P[:, samp]  # (kdim, S)
    Cc = P[:, centers_idx]  # (kdim, k) — padded slots masked below
    d = (
        jnp.sum(Cs * Cs, axis=0)[:, None]
        + jnp.sum(Cc * Cc, axis=0)[None, :]
        - 2.0 * jnp.einsum("ks,kc->sc", Cs, Cc, precision=HI)
    )
    live = jnp.arange(k)[None, :] < n_centers
    d = jnp.where(live, d, jnp.inf)
    dmin = jnp.maximum(jnp.min(d, axis=1), 0.0)  # (S,)
    u = jax.random.uniform(s2, (sample_size,))
    q_s = q[samp]

    def body(s, cur):
        denom = dmin[cur] * q_s[s]
        ratio = jnp.where(denom > 0.0, (dmin[s] * q_s[cur]) / denom, 1.0)
        return jnp.where(ratio > u[s], s, cur)

    cur = jax.lax.fori_loop(1, sample_size, body, jnp.int32(0))
    return samp[cur]


def mcmc_chain_literal(dmin, q_s, u):
    """Sequential oracle of the Metropolis accept/reject recurrence
    (reference src/denseMatrix.cpp:841-869 loop semantics): returns the
    final chain position given per-sample min-dists, proposal masses and
    uniforms."""
    cur = 0
    for s in range(1, len(dmin)):
        denom = dmin[cur] * q_s[s]
        ratio = (dmin[s] * q_s[cur]) / denom if denom > 0 else 1.0
        if ratio > u[s]:
            cur = s
    return cur


def kmeansmcmc_on_projected(
    P: jax.Array,
    k: int,
    key: jax.Array,
    sample_size: int = 10000,
    timer=None,
) -> Tuple[jax.Array, float]:
    """AFK-MC^2 Markov-chain seeding (reference FPDenseMatrix::kmeansmcmc,
    src/denseMatrix.cpp:785-883): between periodic exact min-dist
    refreshes, new centers are chosen by a Metropolis chain over a
    `sample_size` batch drawn from the stale D^2 distribution, with
    acceptance ratio dist(cand) q(cur) / (dist(cur) q(cand)). The
    reference's q regularizer has a sign bug (both axpy's subtract,
    :829,837); we use the published AFK-MC^2 proposal
    q = 0.5 d^2/total + 0.5/D.

    The chain itself runs on device as a lax.fori_loop (one host sync per
    accepted center instead of `sample_size` interpreter iterations), so
    k=1000-scale configs are practical; semantics property-tested against
    mcmc_chain_literal."""
    kdim, D = P.shape
    sample_size = min(sample_size, max(D, 2))
    docs_l2 = jnp.sum(P * P, axis=0)
    key, sub = jax.random.split(key)
    first = int(jax.random.randint(sub, (), 0, D))
    centers = [first]
    min_dist = jnp.maximum(
        docs_l2 + docs_l2[first]
        - 2.0 * jnp.einsum("kd,k->d", P, P[:, first], precision=HI),
        0.0,
    )
    centers_idx = np.zeros(k, np.int32)
    centers_idx[0] = first
    processed = 1
    refresh = 1
    while len(centers) < k:
        # refresh exact min-dists vs centers added since last refresh
        if len(centers) > processed:
            Cn = P[:, jnp.asarray(np.array(centers[processed:]))]
            d = (
                docs_l2[:, None]
                + jnp.sum(Cn * Cn, axis=0)[None, :]
                - 2.0 * jnp.einsum("kd,kc->dc", P, Cn, precision=HI)
            )
            min_dist = jnp.minimum(min_dist, jnp.maximum(jnp.min(d, axis=1), 0.0))
            processed = len(centers)
        total = jnp.maximum(jnp.sum(min_dist), 1e-30)
        q = 0.5 * min_dist / total + 0.5 / D
        refresh += 1
        for _ in range(refresh):
            if len(centers) >= k:
                break
            key, s1 = jax.random.split(key)
            accepted = _mcmc_chain_step(
                P,
                q,
                jnp.asarray(centers_idx),
                jnp.int32(len(centers)),
                s1,
                sample_size,
            )
            centers_idx[len(centers)] = int(accepted)
            centers.append(int(accepted))
    residual = float(jnp.sum(min_dist))
    if timer is not None:
        timer.diag(f"kmeansmcmc picked {k} centers")
    idx = jnp.asarray(np.array(centers[:k], dtype=np.int32))
    return idx, P[:, idx].T, residual


# ---------------------------------------------------------------------------
# Lloyd's on the projected space
# ---------------------------------------------------------------------------


@jax.jit
def projected_sq_dists(P: jax.Array, centers: jax.Array) -> jax.Array:
    """(D, k) squared distances ||P_d - centers_c||^2 in the expanded
    form |p|^2 + |c|^2 - 2 p.c, the reference's distsq computation."""
    docs_l2 = jnp.sum(P * P, axis=0)
    c_l2 = jnp.sum(centers * centers, axis=1)
    dots = jnp.einsum("kd,ck->dc", P, centers, precision=HI)
    return docs_l2[:, None] + c_l2[None, :] - 2.0 * dots


@jax.jit
def _assign_projected(P: jax.Array, centers: jax.Array) -> jax.Array:
    """argmin_c ||P_d - centers_c||^2; first index wins ties (FPimin)."""
    return jnp.argmin(projected_sq_dists(P, centers), axis=1).astype(jnp.int32)


@partial(jax.jit, static_argnames=("k",))
def _update_centers_projected(P: jax.Array, assign: jax.Array, k: int):
    kdim, D = P.shape
    sums = jax.ops.segment_sum(P.T, assign, num_segments=k)  # (k, kdim)
    counts = jax.ops.segment_sum(jnp.ones((D,), jnp.float32), assign, num_segments=k)
    centers = jnp.where(counts[:, None] > 0, sums / counts[:, None], 0.0)
    return centers, counts


@partial(jax.jit, static_argnames=("k", "max_reps"))
def _lloyds_projected_device(P, centers, k: int, max_reps: int):
    """The whole projected Lloyd's loop in one lax.while_loop: a
    host-side membership check would cost a device sync PER REP — same
    fix as _lloyds_full_device."""
    D = P.shape[1]

    def cond(st):
        _, _, done, rep = st
        return (~done) & (rep < max_reps)

    def body(st):
        centers, prev, _, rep = st
        assign = _assign_projected(P, centers)
        centers, _ = _update_centers_projected(P, assign, k)
        done = jnp.all(assign == prev)
        return centers, assign, done, rep + 1

    init = (centers, jnp.full((D,), -1, jnp.int32), jnp.bool_(False),
            jnp.int32(0))
    centers, assign, _, reps = jax.lax.while_loop(cond, body, init)
    return centers, assign, reps


def run_lloyds_projected(
    P: jax.Array, centers: jax.Array, max_reps: int, timer=None
) -> Tuple[jax.Array, jax.Array]:
    """Lloyd's to membership convergence (run_lloyds_on_projected_space,
    src/sparseMatrix.cpp:2016-2072). Returns (centers (k, kdim), assign).
    Same break placement as the reference's host loop: the rep that
    reproduces the previous assignment still updates the centers."""
    k = centers.shape[0]
    centers, assign, reps = _lloyds_projected_device(
        P, centers, k, max_reps
    )
    if timer is not None:
        timer.diag(f"projected lloyds ran {int(reps)} reps (max {max_reps})")
    return centers, assign


# ---------------------------------------------------------------------------
# Lloyd's on the full vocab space (sparse docs)
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("k", "chunk"))
def _update_centers_full(sp, assign: jax.Array, k: int,
                         chunk: int = 1 << 20):
    D = sp.num_docs
    onehot = jax.nn.one_hot(assign, k, dtype=jnp.float32)  # (D, k)
    sums = mat_b_y(sp, onehot, chunk)  # (vocab, k)
    counts = jnp.sum(onehot, axis=0)
    centers = jnp.where(counts[None, :] > 0, sums / counts[None, :], 0.0).T
    return centers, counts


@partial(jax.jit, static_argnames=("k", "chunk"))
def _lloyds_iter_full(sp, centers: jax.Array, docs_l2: jax.Array, k: int,
                      chunk: int = 1 << 20):
    """One fused Lloyd's iteration (assignment + centroid update) in a
    single dispatch."""
    dots = mat_bt_x(sp, centers.T, chunk)  # (D, k)
    c_l2 = jnp.sum(centers * centers, axis=1)
    dists = docs_l2[:, None] + c_l2[None, :] - 2.0 * dots
    assign = jnp.argmin(dists, axis=1).astype(jnp.int32)
    onehot = jax.nn.one_hot(assign, k, dtype=jnp.float32)
    sums = mat_b_y(sp, onehot, chunk)  # (vocab, k)
    counts = jnp.sum(onehot, axis=0)
    centers = jnp.where(counts[None, :] > 0, sums / counts[None, :], 0.0).T
    return centers, assign


@partial(jax.jit, static_argnames=("k", "max_reps", "chunk"))
def _lloyds_full_device(sp, centers, docs_l2, k: int, max_reps: int,
                        chunk: int = 1 << 20):
    """The whole Lloyd's convergence loop in one lax.while_loop: each
    host-side membership check would cost a device sync, so the
    membership-unchanged test runs on device."""
    D = docs_l2.shape[0]

    def cond(st):
        _, _, done, rep = st
        return (~done) & (rep < max_reps)

    def body(st):
        centers, prev, _, rep = st
        centers, assign = _lloyds_iter_full(sp, centers, docs_l2, k, chunk)
        done = jnp.all(assign == prev)
        return centers, assign, done, rep + 1

    init = (centers, jnp.full((D,), -1, jnp.int32), jnp.bool_(False),
            jnp.int32(0))
    centers, assign, _, reps = jax.lax.while_loop(cond, body, init)
    return centers, assign, reps


def run_lloyds_full(
    sp, centers: jax.Array, max_reps: int, timer=None,
    chunk: int = 1 << 20,
) -> Tuple[jax.Array, jax.Array]:
    """Full-space Lloyd's (run_lloyds, src/sparseMatrix.cpp:1689-1746).
    centers: (k, vocab); sp: DocSparse or HybridSparse. Returns
    (centers, assignment). Convergence = unchanged membership; the loop
    runs on device (same break placement as the reference's host loop:
    the iteration that reproduces the previous assignment still updates
    the centers)."""
    k = centers.shape[0]
    docs_l2 = mat_doc_l2sq(sp, chunk)
    centers, assign, reps = _lloyds_full_device(
        sp, centers, docs_l2, k, max_reps, chunk
    )
    if timer is not None:
        timer.diag(f"full lloyds ran {int(reps)} reps (max {max_reps})")
    return centers, assign
