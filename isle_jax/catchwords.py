"""Catchword identification: r-th highest per-(word, cluster) frequency
statistics and the dominance predicate.

Reference semantics:
  - rth_highest_element (src/sparseMatrix.cpp:491-524): for each word and
    cluster, the r-th largest normalized frequency among the cluster's
    docs, where r = floor(eps2 w0 num_docs / (2 k)) (src/trainer.cpp:580-584);
    if the word has <= r occurrences in the cluster the threshold is 0,
    except the degenerate case r >= |cluster| AND the word occurring in
    every doc of the cluster, which takes the minimum.
  - find_catchwords (src/sparseMatrix.cpp:573-594): word w is a catchword
    of topic t iff thr[t, w] > rho * thr[o, w] for every other topic o.

Device design: thr[w, t] is nonzero only for (word, cluster)
groups with MORE than r entries ("big" groups) or the degenerate
full-cluster case — and with the reference's r = eps2·w0·D/(2k)
(src/trainer.cpp:580-584) against a Zipf word marginal, the average
group holds nnz/(V·k) ≪ r entries, so those groups cover a small
fraction of nnz. One counting pass (chunked one-hot row scatters into a
(V, k) matrix) classifies every group; only entries of selected groups
are compacted and sorted by (group, -value); per-group selection is then
one searchsorted over the group ids. This replaced a full-nnz device
sort over every entry. The
dominance predicate is a max/second-max reduction over the (k, vocab)
threshold matrix — no pairwise loop.
"""

from __future__ import annotations

from functools import partial
import jax
import jax.numpy as jnp
import numpy as np

from .sparse import DocSparse


def _count_scan(key, in_cluster, V: int, k: int):
    """(V+1, k) group-count matrix via chunked one-hot row scatters; the
    scan bounds the one-hot temporary to one chunk. int32 accumulator:
    f32 one-hot adds silently stop counting a group at 2^24 entries. NO
    indices_are_sorted: out-of-cluster entries carry the V*k spill key,
    so wrow interleaves [.., w, V, w, ..] — a false sortedness promise
    the backend may exploit into wrong counts."""
    n_pad = key.shape[0]
    cchunk = max(min(1 << 19, n_pad), 1)
    while n_pad % cchunk:
        cchunk //= 2

    def count_body(acc, args):
        kk, ic = args
        wrow = kk // k
        col = kk % k
        g = jax.nn.one_hot(col, k, dtype=jnp.int32)
        g = g * ic[:, None]
        return acc.at[wrow].add(g), None

    cm, _ = jax.lax.scan(
        count_body,
        jnp.zeros((V + 1, k), jnp.int32),
        (
            key.reshape(n_pad // cchunk, cchunk),
            in_cluster.astype(jnp.int32).reshape(n_pad // cchunk, cchunk),
        ),
    )
    return cm


def _entry_groups(A: DocSparse, cluster_of_doc, k: int):
    """Per-entry group key (word*k + cluster, spill V*k for out-of-cluster
    and padded entries) over the WORD-sorted copy."""
    V = A.vocab
    cl = jnp.concatenate([cluster_of_doc, jnp.full((1,), -1, jnp.int32)])
    c = cl[A.w_doc]
    in_cluster = c >= 0
    key = jnp.where(
        in_cluster, A.w_word * k + jnp.maximum(c, 0), V * k
    ).astype(jnp.int32)
    return key, in_cluster


def _group_selection(counts2, csz_row, r: int):
    """Selected-group predicate, the SINGLE source for both jitted passes
    (pass 1 derives per-entry compaction positions from it, pass 2
    derives group start offsets — they silently corrupt if they ever
    diverge): a group is selected when count > r, or in the degenerate
    full-cluster case where the reference reads the group minimum.
    Returns (selected, degenerate), both shaped like counts2."""
    degenerate = (
        (counts2 <= r) & (r >= csz_row) & (counts2 == csz_row)
        & (csz_row > 0)
    )
    return (counts2 > r) | degenerate, degenerate


@partial(jax.jit, static_argnames=("num_topics", "r"))
def _rth_classify(
    A: DocSparse, cluster_of_doc, cluster_sizes, num_topics: int, r: int
):
    """Pass 1: group counts, the selected-group flags (count > r, or the
    degenerate full-cluster case), per-entry compaction positions, and
    the selected-entry total."""
    V, k = A.vocab, num_topics
    key, in_cluster = _entry_groups(A, cluster_of_doc, k)
    counts2 = _count_scan(key, in_cluster, V, k)[:V]
    sel, _ = _group_selection(counts2, cluster_sizes[None, :], r)
    sel_flat = jnp.concatenate(
        [sel.reshape(V * k),
         jnp.zeros((k,), bool)]  # spill groups never selected
    )
    selm = sel_flat[key]
    incl = jnp.cumsum(selm.astype(jnp.int32))
    pos = jnp.where(selm, incl - 1, jnp.int32(0x7FFFFFF0))
    return counts2, pos, incl[-1]


@partial(jax.jit, static_argnames=("num_topics", "r", "Mp"))
def _rth_select(
    A: DocSparse, cluster_of_doc, cluster_sizes, counts2, pos,
    num_topics: int, r: int, Mp: int,
):
    """Pass 2: compact the selected entries, sort by (group, -value), and
    gather the r-th largest / group minimum at searchsorted group starts."""
    V, k = A.vocab, num_topics
    key, _ = _entry_groups(A, cluster_of_doc, k)
    ckey = jnp.full((Mp,), V * k, jnp.int32).at[pos].set(key, mode="drop")
    cval = jnp.zeros((Mp,), jnp.float32).at[pos].set(A.w_val, mode="drop")
    # Sort by (group asc, value desc); values recovered by negation.
    skey, sneg = jax.lax.sort((ckey, -cval), num_keys=2, is_stable=False)
    sval = -sneg

    # Group starts within the compacted array come straight from an
    # exclusive prefix sum of the SELECTED groups' counts in group-id
    # order (one cumsum in place of V*k binary searches).
    cntf = counts2.reshape(V * k)
    sel, degenerate = _group_selection(counts2, cluster_sizes[None, :], r)
    sizes_sel = jnp.where(sel.reshape(V * k), cntf, 0)
    starts = (jnp.cumsum(sizes_sel) - sizes_sel).astype(jnp.int32)
    rth = sval[jnp.clip(starts + (r - 1), 0, Mp - 1)]
    gmin = sval[jnp.clip(starts + cntf - 1, 0, Mp - 1)]

    rth = rth.reshape(V, k)
    gmin = gmin.reshape(V, k)
    thr = jnp.where(counts2 > r, rth, 0.0)
    thr = jnp.where(degenerate, gmin, thr)
    return thr.T.astype(jnp.float32)  # (k, vocab)


def rth_highest(
    A: DocSparse,
    cluster_of_doc: jax.Array,  # (num_docs,) int32, -1 = not in any cluster
    cluster_sizes: jax.Array,  # (num_topics,) int32
    num_topics: int,
    r: int,
    chunk: int = 1 << 20,
) -> jax.Array:
    """Returns thresholds (num_topics, vocab) float32. One host sync
    between the passes fixes the compacted static shape."""
    assert r >= 1, "r = 0 is undefined in the reference (vector[-1] read)"
    cluster_of_doc = jnp.asarray(cluster_of_doc, jnp.int32)
    cluster_sizes = jnp.asarray(cluster_sizes, jnp.int32)
    counts2, pos, m = _rth_classify(
        A, cluster_of_doc, cluster_sizes, num_topics, r
    )
    M = int(m)
    Mp = max(((M + chunk - 1) // chunk) * chunk, 8)
    return _rth_select(
        A, cluster_of_doc, cluster_sizes, counts2, pos,
        num_topics, r, Mp,
    )


@jax.jit
def find_catchwords(thresholds: jax.Array, rho: float) -> jax.Array:
    """Boolean (num_topics, vocab): t's threshold strictly dominates
    rho * every other topic's threshold."""
    k = thresholds.shape[0]
    scaled = rho * thresholds  # (k, V)
    top = jnp.max(scaled, axis=0)  # (V,)
    top_idx = jnp.argmax(scaled, axis=0)
    masked = jnp.where(
        jnp.arange(k)[:, None] == top_idx[None, :], -jnp.inf, scaled
    )
    second = jnp.max(masked, axis=0)  # (V,)
    # For topic t: the max over others is `second` if t holds the top slot
    # (note ties: argmax picks one; other equal-value topics see `top`).
    others_max = jnp.where(jnp.arange(k)[:, None] == top_idx[None, :], second, top)
    is_cw = thresholds > others_max
    if k == 1:
        is_cw = jnp.zeros_like(is_cw)  # no "other" topics -> predicate false
    return is_cw


def catchword_topic_map(is_cw: np.ndarray) -> np.ndarray:
    """(vocab,) int32: owning topic per catchword, -1 otherwise. Catchwords
    are exclusive by construction (strict dominance)."""
    k, V = is_cw.shape
    out = np.full(V, -1, np.int32)
    t, w = np.nonzero(is_cw)
    out[w] = t
    return out
