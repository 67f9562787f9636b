"""Elkan's triangle-inequality k-means (the reference's alternative sparse
k-means, src/sparseMatrix.cpp:2242-2492, selected via
KMEANS_ALGO_FOR_SPARSE).

Elkan's algorithm maintains an upper bound ub_i on each doc's distance to
its assigned center and lower bounds lb_ic to every center; docs whose
bounds prove the assignment cannot change skip the exact distance
computation. The reference re-computes distances only for the flagged
"moving docs" by gathering them into a mini-CSC and running csrmm over it
(src/sparseMatrix.cpp:2390-2460).

Device redesign of the same idea: per iteration the flagged docs (doc-level
Elkan filter: ub_i > s[a_i] AND ub_i > min_{c != a_i} lb_ic — a
conservative union of the paper's per-center conditions, so the kept
assignments are provably optimal for the current centers) are COMPACTED on
device — their entries stream through one cumsum/scatter pass into a
dense-packed mini-COO whose size is bucketed to powers of two (bounded
recompilation) — and the exact-distance SpMM runs only over that packed
subset. When few docs move (late iterations), the per-iteration SpMM cost
drops proportionally, which is exactly the reference's saving re-expressed
with static shapes.

Ties caveat: a pruned doc keeps its assignment when d(i, a) <= d(i, c); on
an exact tie Lloyd's first-index argmin could instead pick a lower-indexed
center, so tie-breaking (and only tie-breaking) may differ from Lloyd's.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

from .hybrid import HybridSparse
from .kmeans import _update_centers_full
from .matops import mat_bt_x, mat_doc_l2sq

HI = jax.lax.Precision.HIGHEST


@partial(jax.jit, static_argnames=("chunk",))
def _exact_dists(sp, centers: jax.Array, docs_l2: jax.Array,
                 chunk: int = 1 << 20):
    dots = mat_bt_x(sp, centers.T, chunk)
    c_l2 = jnp.sum(centers * centers, axis=1)
    d2 = docs_l2[:, None] + c_l2[None, :] - 2.0 * dots
    return jnp.sqrt(jnp.maximum(d2, 0.0))


def _entry_view(sp):
    """(word, doc, val) per-entry arrays of the doc-sorted layout, for
    both storage formats (hybrid tail octet doc ids expand 8-to-1; the
    dense head is handled separately by matmul)."""
    if isinstance(sp, HybridSparse):
        from .hybrid import h_to_doc_sparse_vals

        return h_to_doc_sparse_vals(sp)
    return sp.d_word, sp.d_doc, sp.d_val


@jax.jit
def _flag_stats_device(sp, flagged: jax.Array):
    word, doc, val = _entry_view(sp)
    fl = jnp.concatenate([flagged, jnp.zeros((1,), bool)])
    n_docs = jnp.sum(flagged.astype(jnp.int32))
    n_entries = jnp.sum(fl[doc].astype(jnp.int32))
    return jnp.stack([n_docs, n_entries])


def _flag_stats(sp, flagged: jax.Array):
    """(num flagged docs, num flagged entries) — ONE host sync that fixes
    the mini-batch's static shapes."""
    import numpy as np

    nd, ne = np.asarray(_flag_stats_device(sp, flagged))
    return int(nd), int(ne)


def make_bucket_picker(full_docs: int, full_entries: int,
                       max_buckets: int = 8):
    """Bounded (m_docs, m_entries) bucket grid for the mini exact-distance
    pass: each distinct pair is one jit specialization, and on this
    backend each compile is an erratic remote round trip — cap the grid
    (default 8 + the full-size fallback). Flagged counts shrink as the
    bounds tighten, so early (large) buckets usually cover later reps.
    ONE shared policy for the single-device and mesh Elkan's — tuning it
    here retunes both."""
    full_bucket = (max(full_docs, 8), max(full_entries, 64))
    buckets = []

    def pick_bucket(n_docs: int, n_entries: int):
        fits = [b for b in buckets if b[0] >= n_docs and b[1] >= n_entries]
        if fits:
            return min(fits)
        if len(buckets) >= max_buckets:
            if full_bucket not in buckets:
                buckets.append(full_bucket)
            return full_bucket
        b = (
            min(_pow2_at_least(n_docs, 8), full_bucket[0]),
            min(_pow2_at_least(n_entries, 64), full_bucket[1]),
        )
        buckets.append(b)
        return b

    return pick_bucket


def _pow2_at_least(n: int, lo: int) -> int:
    m = lo
    while m < n:
        m *= 2
    return m


@partial(jax.jit, static_argnames=("m_docs", "m_entries"))
def _flagged_dists(
    sp, flagged: jax.Array, centers: jax.Array, docs_l2: jax.Array,
    m_docs: int, m_entries: int,
):
    """Exact distances for the flagged docs only. Returns
    (ids (m_docs,) original doc ids, dist (m_docs, k)); padding slots carry
    id == num_docs and garbage rows the caller drops via scatter-by-id."""
    word, doc, val = _entry_view(sp)
    D, V, k = sp.num_docs, sp.vocab, centers.shape[0]
    rank = jnp.where(flagged, jnp.cumsum(flagged.astype(jnp.int32)) - 1, m_docs)
    ids = (
        jnp.full((m_docs + 1,), D, jnp.int32)
        .at[rank]
        .set(jnp.arange(D, dtype=jnp.int32), mode="drop")[:m_docs]
    )
    rankp = jnp.concatenate([rank, jnp.full((1,), m_docs, jnp.int32)])
    seg = rankp[jnp.minimum(doc, D)]  # (n_pad,) mini doc rank or spill
    ent = seg < m_docs
    pos = jnp.where(ent, jnp.cumsum(ent.astype(jnp.int32)) - 1, m_entries)
    gw = jnp.full((m_entries,), V, jnp.int32).at[pos].set(word, mode="drop")
    gs = jnp.full((m_entries,), m_docs, jnp.int32).at[pos].set(seg, mode="drop")
    gv = jnp.zeros((m_entries,), jnp.float32).at[pos].set(val, mode="drop")

    X = centers.T  # (vocab, k)
    g = jnp.take(X, gw, axis=0, fill_value=0.0) * gv[:, None]
    # gs is non-decreasing: seg follows the doc-sorted entry order and the
    # compaction preserves it (spill rows sort to the end).
    dots = jax.ops.segment_sum(
        g, gs, num_segments=m_docs + 1, indices_are_sorted=True
    )[:m_docs]
    if isinstance(sp, HybridSparse):
        # dense-head contribution: gather flagged doc columns, one matmul
        Hf = jnp.take(sp.head, jnp.minimum(ids, D - 1), axis=1)  # (R, m)
        Xh = X[sp.head_words]  # (R, k)
        if sp.row_scale is not None:  # binary head: fold scale into Xh
            Xh = Xh * sp.row_scale[sp.head_words][:, None]
        dots = dots + jnp.matmul(
            Hf.T.astype(jnp.float32), Xh, precision=HI
        )
    l2 = jnp.concatenate([docs_l2, jnp.zeros((1,), jnp.float32)])[ids]
    c_l2 = jnp.sum(centers * centers, axis=1)
    d2 = l2[:, None] + c_l2[None, :] - 2.0 * dots
    return ids, jnp.sqrt(jnp.maximum(d2, 0.0))


@jax.jit
def _bounds_filter(ub, lb, s, assign, move):
    """Shift bounds by center movement and compute the doc-level Elkan
    filter."""
    k = lb.shape[1]
    ub = ub + move[assign]
    lb = jnp.maximum(lb - move[None, :], 0.0)
    own = jax.nn.one_hot(assign, k, dtype=bool)
    others_lb = jnp.min(jnp.where(own, jnp.inf, lb), axis=1)
    flagged = (ub > s[assign]) & (ub > others_lb)
    return ub, lb, flagged


@jax.jit
def _half_center_dists(centers):
    k = centers.shape[0]
    c_l2 = jnp.sum(centers * centers, axis=1)
    cc = jnp.sqrt(
        jnp.maximum(
            c_l2[:, None] + c_l2[None, :]
            - 2.0 * jnp.matmul(centers, centers.T, precision=HI),
            0.0,
        )
    )
    cc = cc + jnp.diag(jnp.full((k,), jnp.inf))
    return 0.5 * jnp.min(cc, axis=1)


def run_elkans(
    sp, centers: jax.Array, max_reps: int, timer=None,
    chunk: int = 1 << 20,
) -> Tuple[jax.Array, jax.Array]:
    """Returns (centers (k, vocab), assignment). Same fixpoint as Lloyd's
    (up to exact-tie ordering; see module docstring)."""
    k = centers.shape[0]
    D = sp.num_docs
    docs_l2 = mat_doc_l2sq(sp, chunk)

    dist = _exact_dists(sp, centers, docs_l2, chunk)  # (D, k)
    assign = jnp.argmin(dist, axis=1).astype(jnp.int32)
    ub = jnp.min(dist, axis=1)
    lb = dist
    prev = None

    pad = sp.td_word.shape[0] if isinstance(sp, HybridSparse) \
        else sp.d_word.shape[0]
    pick_bucket = make_bucket_picker(D, pad)

    for rep in range(max_reps):
        centers_new, _ = _update_centers_full(sp, assign, k, chunk)
        move = jnp.linalg.norm(centers_new - centers, axis=1)  # (k,)
        centers = centers_new
        s = _half_center_dists(centers)
        ub, lb, flagged = _bounds_filter(ub, lb, s, assign, move)

        n_docs, n_entries = _flag_stats(sp, flagged)
        if timer is not None:
            timer.diag(
                f"elkans rep {rep}: {n_docs}/{D} docs flagged "
                f"({n_entries} entries)"
            )
        if n_docs > 0:
            m_docs, m_entries = pick_bucket(n_docs, n_entries)
            ids, dmini = _flagged_dists(
                sp, flagged, centers, docs_l2, m_docs, m_entries
            )
            new_a = jnp.argmin(dmini, axis=1).astype(jnp.int32)
            new_ub = jnp.min(dmini, axis=1)
            # scatter mini results back by original doc id (pad ids drop)
            assign_next = assign.at[ids].set(new_a, mode="drop")
            ub = ub.at[ids].set(new_ub, mode="drop")
            lb = lb.at[ids].set(dmini, mode="drop")
        else:
            assign_next = assign

        if prev is not None and bool(jnp.array_equal(assign_next, prev)):
            assign = assign_next
            if timer is not None:
                timer.diag(f"elkans converged at rep {rep}")
            break
        prev = assign_next
        assign = assign_next
    centers, _ = _update_centers_full(sp, assign, k, chunk)
    return centers, assign
