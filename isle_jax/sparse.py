"""Device-resident sparse term-document matrices and the SpMM primitives
every hot kernel in the pipeline reduces to.

Design (replaces reference include/matUtils.h:15-419):

The reference keeps the matrix in MKL CSC + a converted CSR copy and drives
everything through `csrmm`. On the device we keep the SAME dual-order idea but as
flat COO index arrays — one copy sorted by document, one sorted by word —
padded to a static length. The two SpMM directions are then

    B^T X : out[d, :] = sum_{entries e with doc(e)=d} val(e) * X[word(e), :]
    B  Y  : out[w, :] = sum_{entries e with word(e)=w} val(e) * Y[doc(e), :]

i.e. a row gather followed by a segment sum over the sorted index — both
directions stream the nnz arrays in chunks through a `lax.scan` with a
scatter-add into the output, keeping the gathered intermediate at
(chunk, width) regardless of corpus size. This is the analog of the
reference's nnz-balanced row-block streaming (include/matUtils.h:244-268).

Width should be a multiple of 128 for efficiency; callers pad.

After thresholding, B = diag(sqrt(zeta)) * P with P binary
(src/sparseMatrix.cpp:1349), so B's values are stored explicitly but remain
per-word constants; the layout does not exploit this yet (a Pallas kernel
may later).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

DEFAULT_CHUNK = 1 << 20


def _pad_to(x: np.ndarray, n: int, fill) -> np.ndarray:
    if len(x) == n:
        return x
    out = np.full(n, fill, dtype=x.dtype)
    out[: len(x)] = x
    return out


def encode_word_deltas(rows: np.ndarray, offsets: np.ndarray,
                       lo: int = 0, hi: int = None):
    """u16 delta encoding of word ids for the doc range [lo, hi): word ids
    are ascending within each doc, so per-entry deltas (absolute value at
    each doc start) are small non-negative ints; deltas > 65534 (rare —
    big jumps across a sparse doc's vocabulary span) store the sentinel
    65535 with the true value in an exception list. Halves the dominant
    upload array. Returns
    (d16 uint16[n], exc_idx int64[m], exc_val int32[m])."""
    if hi is None:
        hi = len(offsets) - 1
    a, b = int(offsets[lo]), int(offsets[hi])
    r = np.ascontiguousarray(rows[a:b], dtype=np.int32)
    n = len(r)
    if n == 0:
        return (np.zeros(0, np.uint16), np.zeros(0, np.int64),
                np.zeros(0, np.int32))
    # int32 throughout, minimal passes: this runs over every entry of
    # the corpus on the host.
    delta = np.empty(n, np.int32)
    delta[0] = r[0]
    np.subtract(r[1:], r[:-1], out=delta[1:])
    starts = (offsets[lo:hi] - a).astype(np.int64)
    starts = starts[starts < n]
    delta[starts] = r[starts]
    # out-of-range test in one unsigned compare (negatives view huge)
    exc = np.flatnonzero(delta.view(np.uint32) > 65534)
    d16 = delta.astype(np.uint16)  # wraps out-of-range; overwritten next
    d16[exc] = 65535
    return d16, exc, delta[exc].astype(np.int32)


def decode_word_deltas(d16, exc_idx, exc_val, entry_doc_start, in_range,
                       vocab: int, doc_of_entry=None, offsets=None):
    """Device-side inverse of encode_word_deltas (traced inside the
    caller's jit). `entry_doc_start` is each entry's doc-start entry
    index; the int32 running sum may wrap, but the within-doc difference
    is < 2^31 so two's-complement subtraction recovers it exactly.

    When (doc_of_entry, offsets) are given, the per-entry base is read
    as (E ∘ offsets)[doc] — a gather from the small (D+1,) table instead
    of the nnz-sized E table (identical values; the big-table gather
    measured several hundred ms at the 48M shape)."""
    delta = d16.astype(jnp.int32)
    delta = delta.at[exc_idx].set(exc_val, mode="drop")
    G = jnp.cumsum(delta)
    E = jnp.concatenate([jnp.zeros((1,), jnp.int32), G])
    if doc_of_entry is not None:
        base = E[offsets][doc_of_entry]
    else:
        base = E[entry_doc_start]
    w = G - base
    return jnp.where(in_range, jnp.clip(w, 0, vocab), vocab)


def _pad_exceptions(exc_idx: np.ndarray, exc_val: np.ndarray, drop_to: int,
                    min_cap: int = 1):
    """Pad exception arrays to a power-of-two static shape (idx pads point
    past the array -> dropped by the scatter). `min_cap` floors the
    capacity so repeated callers share one jit specialization."""
    m = max(min_cap, len(exc_idx), 1)
    cap = 1 << (m - 1).bit_length()
    idx = np.full(cap, drop_to, np.int64)
    val = np.zeros(cap, np.int32)
    idx[: len(exc_idx)] = exc_idx
    val[: len(exc_val)] = exc_val
    return idx.astype(np.int32), val


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DocSparse:
    """A sparse (vocab x num_docs) matrix as dual-sorted COO with static
    padded length. Padded entries carry word == vocab, doc == num_docs and
    val == 0, and land in spill rows that callers slice off.

    d_*: sorted by (doc, word) — the CSC ordering.
    w_*: sorted by (word, doc) — the CSR ordering.
    """

    d_word: jax.Array
    d_doc: jax.Array
    d_val: jax.Array
    w_word: jax.Array
    w_doc: jax.Array
    w_val: jax.Array
    vocab: int = dataclasses.field(metadata=dict(static=True))
    num_docs: int = dataclasses.field(metadata=dict(static=True))
    nnz: int = dataclasses.field(metadata=dict(static=True))

    @property
    def padded_nnz(self) -> int:
        return self.d_word.shape[0]

    @staticmethod
    def build(
        words: np.ndarray,
        docs: np.ndarray,
        vals: np.ndarray,
        vocab: int,
        num_docs: int,
        chunk: int = DEFAULT_CHUNK,
        doc_sorted: bool = True,
    ) -> "DocSparse":
        """Host-side constructor from COO arrays (doc-sorted unless stated)."""
        from . import native

        words = np.asarray(words, np.int32)
        docs = np.asarray(docs, np.int32)
        vals = np.asarray(vals, np.float32)
        nnz = len(words)
        if not doc_sorted:
            order = native.order_by(docs, words)
            words, docs, vals = words[order], docs[order], vals[order]
        worder = native.order_by(words, docs)
        npad = max(chunk, ((nnz + chunk - 1) // chunk) * chunk)
        return DocSparse(
            d_word=jnp.asarray(_pad_to(words, npad, vocab)),
            d_doc=jnp.asarray(_pad_to(docs, npad, num_docs)),
            d_val=jnp.asarray(_pad_to(vals, npad, 0.0)),
            w_word=jnp.asarray(_pad_to(words[worder], npad, vocab)),
            w_doc=jnp.asarray(_pad_to(docs[worder], npad, num_docs)),
            w_val=jnp.asarray(_pad_to(vals[worder], npad, 0.0)),
            vocab=vocab,
            num_docs=num_docs,
            nnz=nnz,
        )

    @staticmethod
    def from_corpus(
        corpus, chunk: int = DEFAULT_CHUNK, compact_upload: bool = True
    ) -> "DocSparse":
        """Device construction from a host corpus.

        The default path uploads only word ids + raw counts in the
        smallest dtype (plus tiny offsets/doc-sum vectors) and
        reconstructs doc ids, normalized values, and the word-sorted copy
        ON DEVICE — ~5x fewer bytes than shipping both fully-materialized
        sort orders. Whether that pays on a locally attached card is an
        open question (ROADMAP.md, design debt D3)."""
        # The device rebuild recomputes vals as avg * (count / doc_sum);
        # guard that this reproduces corpus.vals bitwise (same check as
        # streaming's loaders and mwu.build_infer_batch) — otherwise
        # (use_int_normalized_counts, normalize_to_one, custom vals) fall
        # back to the full materialized upload. Without this guard the
        # int-normalized flag would silently train on wrong values.
        avg = np.float32(corpus.avg_doc_sz)
        compact_ok = (
            compact_upload
            and corpus.counts is not None
            and corpus.nnz > 0
            and bool(np.all(corpus.counts == np.floor(corpus.counts)))
            and corpus.vals_match(
                lambda c, ds: avg * (c.astype(np.float32) / ds)
            )
        )
        if not compact_ok:
            return DocSparse.build(
                corpus.rows,
                corpus.doc_ids(),
                corpus.vals,
                corpus.vocab_size,
                corpus.num_docs,
                chunk=chunk,
            )
        V, D, nnz = corpus.vocab_size, corpus.num_docs, corpus.nnz
        npad = max(chunk, ((nnz + chunk - 1) // chunk) * chunk)
        cmax = corpus.counts.max() if nnz else 0
        d16, exc_i, exc_v = encode_word_deltas(corpus.rows, corpus.offsets)
        exc_i, exc_v = _pad_exceptions(exc_i, exc_v, npad)
        # Counts: nibble-pack when counts < 15 dominate (bag-of-words
        # counts are tiny — the full u8 array is 48 MB at the NYTimes
        # shape; two counts per byte halves it). Counts
        # >= 15 ride the exception list (sentinel 15, true value
        # scattered on device).
        big = np.flatnonzero(corpus.counts >= 15)
        nibble = nnz > 0 and len(big) < 0.02 * nnz
        if nibble:
            cn = np.minimum(corpus.counts, 15).astype(np.uint8)
            cn = _pad_to(cn, npad, 0)
            packed = (cn[0::2] | (cn[1::2] << 4)).astype(np.uint8)
            counts = jnp.asarray(packed)
            cexc_i, cexc_v = _pad_exceptions(
                big.astype(np.int64),
                corpus.counts[big].astype(np.int32), npad,
            )
        else:
            cdtype = (
                np.uint8 if cmax < 256
                else np.uint16 if cmax < 65536 else np.int32
            )
            counts = jnp.asarray(_pad_to(corpus.counts.astype(cdtype), npad, 0))
            cexc_i, cexc_v = _pad_exceptions(
                np.zeros(0, np.int64), np.zeros(0, np.int32), npad
            )
        offsets = jnp.asarray(corpus.offsets.astype(np.int32))
        doc_sums = np.ones(D + 1, np.float32)
        if nnz:
            doc_sums[:D] = corpus.doc_sums()
        dw, dd, dv, ww, wd, wv = _device_build(
            jnp.asarray(_pad_to(d16, npad, np.uint16(0))),
            jnp.asarray(exc_i),
            jnp.asarray(exc_v),
            counts,
            jnp.asarray(cexc_i),
            jnp.asarray(cexc_v),
            offsets,
            jnp.asarray(doc_sums),
            np.float32(corpus.avg_doc_sz),
            jnp.int32(nnz),
            V,
            D,
            npad,
            nibble,
        )
        return DocSparse(
            d_word=dw, d_doc=dd, d_val=dv,
            w_word=ww, w_doc=wd, w_val=wv,
            vocab=V, num_docs=D, nnz=nnz,
        )


@partial(jax.jit, static_argnames=("vocab", "num_docs", "npad", "nibble"))
def _device_build(d16, exc_i, exc_v, counts, cexc_i, cexc_v, offsets,
                  doc_sums, avg, nnz, vocab, num_docs, npad, nibble):
    """Reconstruct the dual-sorted COO arrays on device from the compact
    upload (u16 word deltas + raw counts [nibble-packed when nibble=True]
    + offsets; see from_corpus)."""
    # doc id per entry: +1 markers at each doc's start offset, cumsum.
    # Empty docs repeat offsets, so scatter-ADD accumulates multiplicity;
    # entries past offsets[num_docs] (padding) land at num_docs.
    marks = jnp.zeros((npad,), jnp.int32).at[offsets[1:]].add(
        1, mode="drop"
    )
    d_doc = jnp.cumsum(marks)
    d_doc = jnp.minimum(d_doc, num_docs)
    in_range = jnp.arange(npad, dtype=jnp.int32) < nnz
    # offsets has num_docs+1 entries and d_doc is clamped to num_docs, so
    # offsets[d_doc] is each entry's doc-start index (pads -> nnz).
    d_word = decode_word_deltas(
        d16, exc_i, exc_v, None, in_range, vocab,
        doc_of_entry=d_doc, offsets=offsets,
    )
    # normalized value = avg * (count / doc_sum) in f32, the same
    # expression as the host computation (src/sparseMatrix.cpp:158-159).
    if nibble:
        lo = (counts & 15).astype(jnp.float32)
        hi = (counts >> 4).astype(jnp.float32)
        c = jnp.stack([lo, hi], axis=1).reshape(npad)
        c = c.at[cexc_i].set(cexc_v.astype(jnp.float32), mode="drop")
    else:
        c = counts.astype(jnp.float32)
    d_val = jnp.where(
        d_word < vocab, avg * (c / doc_sums[d_doc]), 0.0
    ).astype(jnp.float32)
    # word-sorted copy: lexicographic (word, doc) sort; padding (word ==
    # vocab) sorts to the end.
    ww, wd, wv = jax.lax.sort((d_word, d_doc, d_val), num_keys=2)
    return d_word, d_doc, d_val, ww, wd, wv


def _chunked_gather_segsum(
    idx_gather: jax.Array,
    idx_segment: jax.Array,
    vals: jax.Array,
    X: jax.Array,
    num_segments: int,
    chunk: int,
) -> jax.Array:
    """out[s, :] = sum over entries e with idx_segment[e]==s of
    vals[e] * X[idx_gather[e], :], streamed in nnz chunks."""
    n = idx_gather.shape[0]
    assert n % chunk == 0, (n, chunk)
    nchunks = n // chunk
    width = X.shape[1]
    ig = idx_gather.reshape(nchunks, chunk)
    isg = idx_segment.reshape(nchunks, chunk)
    vs = vals.reshape(nchunks, chunk)

    def body(acc, args):
        g_idx, s_idx, v = args
        g = jnp.take(X, g_idx, axis=0, fill_value=0.0) * v[:, None]
        acc = acc.at[s_idx].add(g, indices_are_sorted=True)
        return acc, None

    init = jnp.zeros((num_segments, width), dtype=X.dtype)
    out, _ = jax.lax.scan(body, init, (ig, isg, vs))
    return out


@partial(jax.jit, static_argnames=("chunk",))
def bt_x(sp: DocSparse, X: jax.Array, chunk: int = DEFAULT_CHUNK) -> jax.Array:
    """B^T X: (num_docs, width) from X (vocab[+1], width).

    X may have vocab or vocab+1 rows; gathers of the padding word id use
    fill_value 0 when X has exactly `vocab` rows."""
    chunk = min(chunk, sp.padded_nnz)
    out = _chunked_gather_segsum(
        sp.d_word, sp.d_doc, sp.d_val, X, sp.num_docs + 1, chunk
    )
    return out[: sp.num_docs]


@partial(jax.jit, static_argnames=("chunk",))
def b_y(sp: DocSparse, Y: jax.Array, chunk: int = DEFAULT_CHUNK) -> jax.Array:
    """B Y: (vocab, width) from Y (num_docs[+1], width)."""
    chunk = min(chunk, sp.padded_nnz)
    out = _chunked_gather_segsum(
        sp.w_doc, sp.w_word, sp.w_val, Y, sp.vocab + 1, chunk
    )
    return out[: sp.vocab]


@partial(jax.jit, static_argnames=("chunk",))
def gram_x(sp: DocSparse, X: jax.Array, chunk: int = DEFAULT_CHUNK) -> jax.Array:
    """(B B^T) X — the eigensolver operator (reference
    include/matUtils.h:336-365 `MKL_SpSpTrProd::multiply`)."""
    return b_y(sp, bt_x(sp, X, chunk), chunk)


@partial(jax.jit, static_argnames=("chunk",))
def doc_l2sq(sp: DocSparse, chunk: int = DEFAULT_CHUNK) -> jax.Array:
    """Per-document squared l2 norms (src/sparseMatrix.cpp:1679-1686)."""
    chunk = min(chunk, sp.padded_nnz)
    n = sp.padded_nnz // chunk

    def body(acc, args):
        d, v = args
        return acc.at[d].add(v * v, indices_are_sorted=True), None

    out, _ = jax.lax.scan(
        body,
        jnp.zeros(sp.num_docs + 1, jnp.float32),
        (sp.d_doc.reshape(n, chunk), sp.d_val.reshape(n, chunk)),
    )
    return out[: sp.num_docs]


@partial(jax.jit, static_argnames=("chunk",))
def frobenius_sq(sp: DocSparse, chunk: int = DEFAULT_CHUNK) -> jax.Array:
    return jnp.sum(doc_l2sq(sp, chunk))


def spmm_flops(sp: DocSparse, width: int) -> int:
    """FLOPs of one bt_x or b_y call (2*nnz*width), for the GFLOP/s
    counter (reference include/matUtils.h:270-308 self-profiling)."""
    return 2 * sp.nnz * width


def to_dense(sp: DocSparse) -> np.ndarray:
    """Densify (tests/small problems only)."""
    out = np.zeros((sp.vocab + 1, sp.num_docs + 1), dtype=np.float32)
    w = np.asarray(sp.d_word)
    d = np.asarray(sp.d_doc)
    v = np.asarray(sp.d_val)
    np.add.at(out, (w, d), v)
    return out[: sp.vocab, : sp.num_docs]
