"""Construction of the thresholded, sqrt-scaled matrix B from the
normalized corpus A, with optional importance sampling of documents.

Reference semantics:
  - threshold_and_copy (src/sparseMatrix.cpp:1285-1362): keep entries with
    round(normalized_val) >= zeta[word]; set value to sqrt(zeta[word])
    (:1349); drop documents left empty; record `original_cols` mapping new
    column ids to original doc ids.
  - sampled_threshold_and_copy (src/sparseMatrix.cpp:1365-1435): document
    weight = sum of zeta over the doc's passing entries; an exponential race
    dice = U^(1/weight) (0 for weight 0) keeps the top sample_rate fraction:
    pivot = the floor(sample_rate * num_docs)-th largest dice, keep docs
    with dice >= pivot.

Device design: the keep-mask, document renumbering (prefix sum over occupied
docs) and stable compaction (scatter by cumulative position) all run on
device; only the final kept-entry count syncs to host to fix static array
sizes. Compaction happens independently in both sort orders, so no device
sort is ever needed.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .sparse import DocSparse


@jax.jit
def _keep_mask(word: jax.Array, val: jax.Array, zetas: jax.Array) -> jax.Array:
    """Entries surviving thresholding: round(val) >= zeta[word]; padded
    entries (word == vocab) hit the +inf spill slot and never survive."""
    z = jnp.concatenate([zetas, jnp.full((1,), jnp.inf, zetas.dtype)])
    return jnp.floor(val + 0.5) >= z[word]


@partial(jax.jit, static_argnames=("num_docs", "pivot_index"))
def _sample_select(
    word: jax.Array,
    doc: jax.Array,
    keep: jax.Array,
    zetas: jax.Array,
    num_docs: int,
    pivot_index: int,
    key: jax.Array,
) -> jax.Array:
    """Importance-sampled doc selection (src/sparseMatrix.cpp:1383-1417).
    Returns a boolean per-doc selection mask."""
    z = jnp.concatenate([zetas, jnp.zeros((1,), zetas.dtype)])
    w = jax.ops.segment_sum(
        jnp.where(keep, z[word], 0.0), doc, num_segments=num_docs + 1,
        indices_are_sorted=True,
    )[:num_docs]
    u = jax.random.uniform(key, (num_docs,), dtype=jnp.float32)
    dice = jnp.where(w > 0.0, jnp.power(u, 1.0 / jnp.maximum(w, 1e-30)), 0.0)
    # Explicit clamp: sample_rate >= 1.0 gives pivot_index == num_docs,
    # which previously kept all docs only via JAX's silent out-of-bounds
    # gather clamp — make the keep-everything semantics deliberate.
    pivot = jnp.sort(dice)[::-1][min(pivot_index, num_docs - 1)]
    return dice >= pivot


@partial(jax.jit, static_argnames=("vocab", "npad", "nz_docs"))
def _compact_b(
    word, doc, keep, zetas, new_doc, vocab: int, npad: int, nz_docs: int
):
    """Stable compaction of surviving entries with sqrt(zeta) values and
    renumbered doc ids (threshold_and_copy_doc_block semantics,
    src/sparseMatrix.cpp:1328-1362)."""
    pos = jnp.where(keep, jnp.cumsum(keep.astype(jnp.int32)) - 1, npad)
    nd = jnp.concatenate([new_doc, jnp.full((1,), nz_docs, jnp.int32)])
    out_w = jnp.full((npad,), vocab, jnp.int32).at[pos].set(word, mode="drop")
    out_d = (
        jnp.full((npad,), nz_docs, jnp.int32).at[pos].set(nd[doc], mode="drop")
    )
    sz = jnp.concatenate([jnp.sqrt(zetas), jnp.zeros((1,), jnp.float32)])
    out_v = jnp.zeros((npad,), jnp.float32).at[pos].set(sz[word], mode="drop")
    return out_w, out_d, out_v


def threshold_and_copy(
    A: DocSparse,
    zetas: jax.Array,
    sample_rate: Optional[float] = None,
    key: Optional[jax.Array] = None,
    chunk: int = 1 << 20,
) -> Tuple[DocSparse, np.ndarray]:
    """Build B from A. Returns (B, original_cols host array).

    When sample_rate is given, applies importance sampling of documents
    with the provided PRNG key (the reference uses unseeded rand();
    determinism here is intentional).
    """
    V, D = A.vocab, A.num_docs
    zetas = jnp.asarray(zetas, jnp.float32)
    keep_d = _keep_mask(A.d_word, A.d_val, zetas)

    if sample_rate is not None:
        assert key is not None
        pivot_index = int(sample_rate * D)
        sel = _sample_select(A.d_word, A.d_doc, keep_d, zetas, D, pivot_index, key)
        selp = jnp.concatenate([sel, jnp.zeros((1,), bool)])
        keep_d = keep_d & selp[A.d_doc]

    # Document occupancy -> renumbering (prefix sum) and original_cols.
    occ = (
        jax.ops.segment_sum(
            keep_d.astype(jnp.int32), A.d_doc, num_segments=D + 1,
            indices_are_sorted=True,
        )[:D]
        > 0
    )
    new_doc = jnp.cumsum(occ.astype(jnp.int32)) - 1  # valid where occ
    nz_docs = int(jnp.sum(occ))
    original_cols = np.flatnonzero(np.asarray(occ)).astype(np.int32)

    new_nnz = int(jnp.sum(keep_d))
    npad = max(chunk, ((new_nnz + chunk - 1) // chunk) * chunk)

    dw, dd, dv = _compact_b(
        A.d_word, A.d_doc, keep_d, zetas, new_doc, V, npad, nz_docs
    )

    keep_w = _keep_mask(A.w_word, A.w_val, zetas)
    if sample_rate is not None:
        keep_w = keep_w & selp[A.w_doc]
    ww, wd, wv = _compact_b(
        A.w_word, A.w_doc, keep_w, zetas, new_doc, V, npad, nz_docs
    )

    B = DocSparse(
        d_word=dw,
        d_doc=dd,
        d_val=dv,
        w_word=ww,
        w_doc=wd,
        w_val=wv,
        vocab=V,
        num_docs=nz_docs,
        nnz=new_nnz,
    )
    return B, original_cols


def threshold_and_copy_np(
    words: np.ndarray,
    docs: np.ndarray,
    vals: np.ndarray,
    zetas: np.ndarray,
    num_docs: int,
    select_docs: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Numpy reference: returns (words, new_docs, sqrt-zeta vals,
    original_cols). Input must be doc-sorted."""
    keep = np.floor(vals + 0.5) >= zetas[words]
    if select_docs is not None:
        keep &= select_docs[docs]
    kw, kd = words[keep], docs[keep]
    occ = np.zeros(num_docs, dtype=bool)
    occ[kd] = True
    original_cols = np.flatnonzero(occ).astype(np.int32)
    renum = np.zeros(num_docs, dtype=np.int32)
    renum[original_cols] = np.arange(len(original_cols), dtype=np.int32)
    return (
        kw.astype(np.int32),
        renum[kd],
        np.sqrt(zetas[kw]).astype(np.float32),
        original_cols,
    )
