"""Topic-matrix construction and edge (compound) topics.

Reference semantics (src/sparseMatrix.cpp:597-838 `construct_topic_model`,
live code paths):
  1. For each doc, the per-topic catchword mass: sum of the doc's
     normalized counts over each topic's catchwords (:661-672).
  2. Top-2 topics per doc by a strictly-greater scan in topic order
     (:687-708), kept when both are positive.
  3. Per-topic model threshold: the rank_threshold-th largest positive
     catchword mass, rank_threshold = int(eps3 w0 D / (2 k)), 0 when the
     topic has fewer qualifying docs (:722-754).
  4. Topic vector = sum of normalized counts of (a) docs whose catchword
     mass STRICTLY exceeds the topic threshold (:806-817) PLUS (b) every
     doc of the topic's k-means cluster (:792-821 — the live loop applies
     to all topics, not only catchless ones; docs can contribute twice).
  5. l1 normalization per topic (:828-831).

Edge topics v2 (src/trainer.cpp:1118-1168): count docs per (top1, top2)
pair; keep pairs with >= edge_topic_min_docs docs; order by count
descending, truncate to max_edge_topics; edge vector = 0.7 * topic_a +
0.3 * topic_b. The reference's sort is unstable in count ties; we break
ties by (t1, t2) for determinism.

Device design: step 1 is a chunked scatter-add into a dense (docs x k) mass
matrix; step 3 a column sort; step 4 is ONE SpMM — Model = A @ W with
W[d, t] = (mass[d, t] > thr[t]) + (cluster_of[d] == t) — using the b_y
primitive.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .sparse import DocSparse, b_y


@partial(jax.jit, static_argnames=("num_topics", "chunk"))
def doc_topic_mass(
    A: DocSparse,
    cw_topic: jax.Array,  # (vocab,) int32 owning topic per word, -1 else
    num_topics: int,
    chunk: int = 1 << 20,
) -> jax.Array:
    """(num_docs, num_topics) catchword mass per doc."""
    k = num_topics
    D = A.num_docs
    cwt = jnp.concatenate([cw_topic, jnp.full((1,), -1, jnp.int32)])
    chunk = max(min(chunk, A.padded_nnz), 1)
    while A.padded_nnz % chunk:  # divide down to a divisor of the pad
        chunk //= 2
    n = A.padded_nnz // chunk
    words = A.d_word.reshape(n, chunk)
    docs = A.d_doc.reshape(n, chunk)
    vals = A.d_val.reshape(n, chunk)

    # Flat scatter carry (see hybrid.py on 2D-scatter index layouts).
    # The flat index must fit int32 (x64 is off): (D+1)*k < 2^31. Beyond
    # that the accumulator itself is ~8+ GB — shard docs over a mesh
    # (sharding.sharded_doc_topic_mass) instead. Fail loudly rather than
    # let the index wrap.
    assert (D + 1) * k < (1 << 31), (
        f"(num_docs+1)*k = {(D + 1) * k} exceeds int32 flat indexing; "
        "use the doc-sharded mesh path"
    )

    def body(acc, args):
        w, d, v = args
        t = cwt[w]
        is_cw = t >= 0
        # Flat SCALAR scatter: a k-wide one-hot row scatter keyed by the
        # doc id would write k times the bytes of one scalar per entry.
        dd = jnp.where(is_cw, d, D)
        acc = acc.at[dd * jnp.int32(k) + jnp.maximum(t, 0)].add(
            jnp.where(is_cw, v, 0.0)
        )
        return acc, None

    out, _ = jax.lax.scan(
        body, jnp.zeros(((D + 1) * k,), jnp.float32), (words, docs, vals)
    )
    return out.reshape(D + 1, k)[:D]


@partial(jax.jit, static_argnames=("rank_threshold",))
def model_thresholds(mass: jax.Array, has_catchwords: jax.Array, rank_threshold: int):
    """Per-topic threshold: rank_threshold-th largest positive mass
    (0 if fewer than rank_threshold docs qualify or no catchwords)."""
    D, k = mass.shape
    pos_counts = jnp.sum(mass > 0.0, axis=0)  # (k,)
    if rank_threshold <= 0 or rank_threshold > D:
        thr = jnp.zeros((k,), jnp.float32)
    elif D * k <= (1 << 27):
        svals = -jnp.sort(-mass, axis=0)  # descending per column
        thr = svals[rank_threshold - 1]
        thr = jnp.where(pos_counts >= rank_threshold, thr, 0.0)
    else:
        # Large D (PubMed: 8.2M docs): an axis-0 sort of (D, k) pads every
        # column to the sort's power-of-two scratch at once and exhausts
        # HBM; select the rank statistic one topic at a time instead.
        # Map over column INDICES — mapping over mass.T materializes a
        # transposed (k, D) copy (3.3 GB at PubMed; observed OOM).
        def col_thr(i):
            col = jax.lax.dynamic_index_in_dim(mass, i, axis=1,
                                               keepdims=False)
            s = -jnp.sort(-col)
            return s[rank_threshold - 1]

        thr = jax.lax.map(col_thr, jnp.arange(k, dtype=jnp.int32))
        thr = jnp.where(pos_counts >= rank_threshold, thr, 0.0)
    return jnp.where(has_catchwords, thr, 0.0)


@jax.jit
def top_two_topics(mass: jax.Array):
    """First-index max and runner-up per doc, reference scan semantics.
    Returns (t1, t2, valid) with valid = both strictly positive."""
    D, k = mass.shape
    v1 = jnp.max(mass, axis=1)
    t1 = jnp.argmax(mass, axis=1)
    # Elementwise mask of the winner column (a (D,2)-indexed scatter here
    # would materialize a tiled (D, 2) index operand; see hybrid.py).
    cols = jnp.arange(k, dtype=t1.dtype)[None, :]
    masked = jnp.where(cols == t1[:, None], -jnp.inf, mass)
    v2 = jnp.max(masked, axis=1)
    t2 = jnp.argmax(masked, axis=1)
    valid = (v1 > 0.0) & (v2 > 0.0)
    return t1.astype(jnp.int32), t2.astype(jnp.int32), valid


@partial(jax.jit, donate_argnums=(0,))
def _contribution_weights(
    mass: jax.Array, thr: jax.Array, cluster_of_doc: jax.Array
) -> jax.Array:
    """`mass` is DONATED (same (D, k) f32 shape as the returned W, so XLA
    reuses the buffer — at PubMed scale holding both cost 6.6 GB at the
    peak). Callers must not touch mass afterwards; both call sites
    compute thr/pairs first."""
    D, k = mass.shape
    W = (mass > thr[None, :]).astype(jnp.float32)
    in_cluster = cluster_of_doc >= 0
    W = W + jax.nn.one_hot(
        jnp.where(in_cluster, cluster_of_doc, k), k, dtype=jnp.float32
    )
    return W


def construct_topic_model(
    A: DocSparse,
    cw_topic: jax.Array,
    cluster_of_doc: jax.Array,
    num_topics: int,
    rank_threshold: int,
    want_top_pairs: bool = False,
    chunk: int = 1 << 20,
):
    """Returns (Model (vocab, k) l1-normalized, (t1, t2, valid) or None).

    `cluster_of_doc` maps ORIGINAL doc ids to their k-means topic (-1 for
    docs dropped by thresholding/sampling)."""
    has_cw = jax.ops.segment_sum(
        (cw_topic >= 0).astype(jnp.int32),
        jnp.maximum(cw_topic, 0),
        num_segments=num_topics,
    ) > 0
    mass = doc_topic_mass(A, cw_topic, num_topics, chunk)
    thr = model_thresholds(mass, has_cw, rank_threshold)
    pairs = top_two_topics(mass) if want_top_pairs else None
    W = _contribution_weights(mass, thr, cluster_of_doc)
    model = b_y(A, W, chunk)  # (vocab, k)
    sums = jnp.sum(model, axis=0)
    model = jnp.where(sums[None, :] != 0.0, model / sums[None, :], model)
    return model, pairs


def construct_edge_topics_v1(
    A: DocSparse,
    t1: np.ndarray,
    t2: np.ndarray,
    valid: np.ndarray,
    original_doc_ids: Optional[np.ndarray],
    num_topics: int,
    max_edge_topics: int,
    min_docs: int = 1,
) -> Tuple[np.ndarray, np.ndarray]:
    """Edge topics v1 — doc-average variant (src/trainer.cpp:1042-1114):
    edge vector = mean of the normalized counts of the docs whose top-2
    pair selected it (instead of blending the two topic vectors).
    `t1/t2/valid` are per-doc (indexed like A's docs unless
    original_doc_ids maps them). One SpMM computes all edge vectors."""
    k = num_topics
    keys = t1.astype(np.int64) * k + t2.astype(np.int64)
    doc_ids = np.arange(len(t1)) if original_doc_ids is None else original_doc_ids
    keys_v = keys[valid]
    docs_v = doc_ids[valid]
    counts = np.bincount(keys_v, minlength=k * k)
    cand = np.nonzero(counts >= max(min_docs, 1))[0]
    order = np.lexsort((cand % k, cand // k, -counts[cand]))
    cand = cand[order][:max_edge_topics]
    # per-doc edge-topic index (or -1)
    edge_of_pair = np.full(k * k, -1, np.int64)
    edge_of_pair[cand] = np.arange(len(cand))
    e = edge_of_pair[keys_v]
    sel_mask = e >= 0
    n_edges = len(cand)
    W = np.zeros((A.num_docs, n_edges), np.float32)
    W[docs_v[sel_mask], e[sel_mask]] = 1.0 / counts[cand][e[sel_mask]]
    edge = np.asarray(b_y(A, jnp.asarray(W)))
    sel = np.stack(
        [(cand // k).astype(np.int32), (cand % k).astype(np.int32),
         counts[cand].astype(np.int32)], axis=1,
    )
    return edge.astype(np.float32), sel


def construct_edge_topics_v2(
    t1: np.ndarray,
    t2: np.ndarray,
    valid: np.ndarray,
    model: np.ndarray,
    num_topics: int,
    max_edge_topics: int,
    min_docs: int = 1,
    primary_ratio: float = 0.7,
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (edge_model (vocab, n_edges), selected pairs (n_edges, 3)
    of [t1, t2, count]). Host-side: inputs are tiny (per-doc pairs)."""
    k = num_topics
    keys = t1.astype(np.int64) * k + t2.astype(np.int64)
    keys = keys[valid]
    counts = np.bincount(keys, minlength=k * k)
    cand = np.nonzero(counts >= max(min_docs, 1))[0]
    # Order by count desc, tie-break (t1, t2) asc for determinism.
    order = np.lexsort((cand % k, cand // k, -counts[cand]))
    cand = cand[order][:max_edge_topics]
    a = (cand // k).astype(np.int32)
    b = (cand % k).astype(np.int32)
    edge = primary_ratio * model[:, a] + (1.0 - primary_ratio) * model[:, b]
    sel = np.stack([a, b, counts[cand].astype(np.int32)], axis=1)
    return edge.astype(np.float32), sel
