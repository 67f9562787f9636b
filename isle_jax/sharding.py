"""Multi-device execution: document-axis sharding over a device mesh.

The reference is a single-node shared-memory code (SURVEY.md §2: no
MPI/NCCL anywhere); its scale axes are doc-block streaming and nnz-balanced
chunking. The JAX translation (SURVEY.md §5.7-5.8) shards the
DOCUMENT axis of the term-document matrix across a 1-D mesh:

  - each device holds a contiguous doc range's COO entries (padded to the
    per-device max), with doc ids local to the shard;
  - B^T X keeps X replicated and yields doc-sharded rows with NO
    communication;
  - B Y reduces per-device partial (vocab, width) products with a psum
    over the device interconnect;
  - k-means assignments stay local; center/count updates psum;
  - the per-word threshold histogram psums;
  - MWU inference is embarrassingly doc-parallel.

Everything routes through shard_map so the collectives are explicit; k- and
vocab-dimension state (U, centers, model) is replicated — it is tiny
relative to the nnz payload, exactly like the reference's shared-memory
k x k state.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .sparse import DocSparse

AXIS = "docs"


def _pvary(x, axis: str = AXIS):
    """Mark a locally-created constant as device-varying inside shard_map
    (jax.lax.pvary is deprecated in favor of pcast)."""
    return jax.lax.pcast(x, axis, to="varying")


from collections import OrderedDict

# LRU-bounded: keys carry run-dependent statics (pad sizes, mesh), so a
# long-lived process training many differently-shaped corpora would
# otherwise pin compiled executables forever. 256 entries comfortably
# covers one pipeline's distinct stages times a handful of shapes.
_SM_JIT_CACHE: OrderedDict = OrderedDict()
_SM_JIT_CACHE_MAX = 256


def _cache_get(k):
    got = _SM_JIT_CACHE.get(k)
    if got is not None:
        _SM_JIT_CACHE.move_to_end(k)
    return got


def _cache_put(k, v):
    _SM_JIT_CACHE[k] = v
    while len(_SM_JIT_CACHE) > _SM_JIT_CACHE_MAX:
        _SM_JIT_CACHE.popitem(last=False)


def _sm(key, build, mesh, in_specs, out_specs):
    """Cached jax.jit(jax.shard_map(...)) — the mesh stages' dispatch path.

    Eager shard_map executes its body one primitive at a time: every op
    becomes its own mini-program + per-device dispatch (hundreds per
    stage), which the persistent compile cache cannot amortize (the tiny
    config-matrix sharded train spent 16 s in the eager hybrid build
    alone, identical run to run). Jitting the
    shard_map makes each stage ONE compiled, cacheable program.

    jax.jit caches on function identity, and both the shard-mapped
    closure and the shard_map wrapper are fresh objects at every call —
    so the jitted callable itself is cached here, keyed by `key` + mesh
    + specs. `key` MUST name the builder and every value its closure
    captures (shapes/dtypes are handled by jit's own cache); an
    incomplete key silently reuses a program with stale constants.
    `build` is a zero-arg callable returning the shard-mapped fn,
    invoked only on cache miss. Arrays must be passed as shard_map
    arguments, never closed over (closed-over arrays bake into the HLO
    as constants and bloat every compile)."""
    k = (key, mesh, in_specs, out_specs)
    got = _cache_get(k)
    if got is None:
        got = jax.jit(jax.shard_map(
            build(), mesh=mesh, in_specs=in_specs, out_specs=out_specs
        ))
        _cache_put(k, got)
    return got


def _cached_step(key, build):
    """Cache for jitted multi-shard_map step functions (Lloyd's/Elkan's
    iteration bodies): jax.jit caches on function identity, so a step
    rebuilt per trainer recompiles per trainer. Key rules as in _sm."""
    got = _cache_get(key)
    if got is None:
        got = build()
        _cache_put(key, got)
    return got


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), (AXIS,))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ShardedDocSparse:
    """Doc-sharded COO: leading axis = device shard. Entry doc ids are
    LOCAL to the shard; `doc_offset[s]` maps back to global ids. Both sort
    orders hold the same shard's entries (word-sorted within the shard)."""

    d_word: jax.Array  # (S, n_pad)
    d_doc: jax.Array  # (S, n_pad) local ids
    d_val: jax.Array
    w_word: jax.Array
    w_doc: jax.Array
    w_val: jax.Array
    doc_offset: jax.Array  # (S,)
    vocab: int = dataclasses.field(metadata=dict(static=True))
    docs_per_shard: int = dataclasses.field(metadata=dict(static=True))
    num_docs: int = dataclasses.field(metadata=dict(static=True))
    nnz: int = dataclasses.field(metadata=dict(static=True))
    # Per-shard count of VALID doc slots (ragged shards, e.g. the
    # thresholded B whose shards keep different doc counts), as a hashable
    # tuple (static aux data). None means the even split
    # min(dps, num_docs - s*dps).
    valid_docs: Optional[Tuple[int, ...]] = dataclasses.field(
        default=None, metadata=dict(static=True)
    )

    @property
    def num_shards(self) -> int:
        return self.d_word.shape[0]

    def valid_per_shard(self) -> np.ndarray:
        """(S,) valid doc slots per shard."""
        if self.valid_docs is not None:
            return np.asarray(self.valid_docs)
        S, dps = self.num_shards, self.docs_per_shard
        return np.clip(
            self.num_docs - np.arange(S) * dps, 0, dps
        ).astype(np.int64)


def shard_doc_sparse(
    words: np.ndarray,
    docs: np.ndarray,
    vals: np.ndarray,
    vocab: int,
    num_docs: int,
    mesh: Mesh,
    pad_multiple: int = 1 << 13,
) -> ShardedDocSparse:
    """Host-side: split doc-sorted COO into contiguous doc ranges, one per
    device, each padded to the common max entry count."""
    S = mesh.devices.size
    dps = -(-num_docs // S)  # docs per shard
    words = np.asarray(words, np.int32)
    docs = np.asarray(docs, np.int32)
    vals = np.asarray(vals, np.float32)
    bounds = np.searchsorted(docs, np.arange(0, (S + 1) * dps, dps))
    max_n = int((np.diff(bounds)).max()) if len(words) else 0
    n_pad = max(pad_multiple, -(-max_n // pad_multiple) * pad_multiple)

    def shard_arrays(order_key):
        dw = np.full((S, n_pad), vocab, np.int32)
        dd = np.full((S, n_pad), dps, np.int32)
        dv = np.zeros((S, n_pad), np.float32)
        for s in range(S):
            lo, hi = bounds[s], bounds[s + 1]
            w, d, v = words[lo:hi], docs[lo:hi] - s * dps, vals[lo:hi]
            if order_key == "word":
                o = np.lexsort((d, w))
                w, d, v = w[o], d[o], v[o]
            dw[s, : hi - lo] = w
            dd[s, : hi - lo] = d
            dv[s, : hi - lo] = v
        return dw, dd, dv

    dw, dd, dv = shard_arrays("doc")
    ww, wd, wv = shard_arrays("word")
    sh = NamedSharding(mesh, P(AXIS))
    put = lambda x: jax.device_put(x, sh)
    return ShardedDocSparse(
        d_word=put(dw),
        d_doc=put(dd),
        d_val=put(dv),
        w_word=put(ww),
        w_doc=put(wd),
        w_val=put(wv),
        doc_offset=jax.device_put(
            np.arange(S, dtype=np.int32)[:, None] * dps, sh
        ),
        vocab=vocab,
        docs_per_shard=dps,
        num_docs=num_docs,
        nnz=len(words),
    )


def from_doc_sparse(sp: DocSparse, mesh: Mesh) -> ShardedDocSparse:
    n = sp.nnz
    return shard_doc_sparse(
        np.asarray(sp.d_word)[:n],
        np.asarray(sp.d_doc)[:n],
        np.asarray(sp.d_val)[:n],
        sp.vocab,
        sp.num_docs,
        mesh,
    )


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class WordSharded:
    """Word-axis sharding: each device owns a contiguous, nnz-balanced
    word range (the multi-chip analog of the reference's word-major CSR
    sidecar, src/trainer.cpp:296-362). Word ids are LOCAL to the shard;
    doc ids stay global. Word-parallel stages (zeta thresholds, r-th
    highest catchword statistics) then run with NO communication beyond
    assembling small per-word outputs."""

    w_word: jax.Array  # (S, n_pad) local word ids, pad = words_per_shard
    w_doc: jax.Array  # (S, n_pad) global doc ids, pad = num_docs
    w_val: jax.Array  # (S, n_pad)
    vocab: int = dataclasses.field(metadata=dict(static=True))
    num_docs: int = dataclasses.field(metadata=dict(static=True))
    words_per_shard: int = dataclasses.field(metadata=dict(static=True))
    nnz: int = dataclasses.field(metadata=dict(static=True))

    # host-side metadata (not part of the pytree)
    word_start: np.ndarray = dataclasses.field(
        metadata=dict(static=False), default=None
    )

    @property
    def num_shards(self) -> int:
        return self.w_word.shape[0]


def shard_by_word(
    words: np.ndarray,
    docs: np.ndarray,
    vals: np.ndarray,
    vocab: int,
    num_docs: int,
    mesh: Mesh,
    pad_multiple: int = 1 << 13,
) -> WordSharded:
    """Host-side: word-sorted COO split into nnz-balanced contiguous word
    ranges, one per device."""
    S = mesh.devices.size
    words = np.asarray(words, np.int64)
    order = np.argsort(words, kind="stable")
    words, docs, vals = words[order], np.asarray(docs)[order], np.asarray(vals)[order]
    n = len(words)
    # nnz-balanced boundaries on word ids
    targets = (np.arange(1, S) * n) // S
    cut_words = words[np.minimum(targets, max(n - 1, 0))] + 1 if n else np.array([])
    bounds_w = np.concatenate([[0], cut_words, [vocab]]).astype(np.int64)
    bounds_w = np.maximum.accumulate(bounds_w)
    bounds_n = np.searchsorted(words, bounds_w)
    wps = int(max((np.diff(bounds_w)).max() if S else vocab, 1))
    max_n = int((np.diff(bounds_n)).max()) if n else 0
    n_pad = max(pad_multiple, -(-max_n // pad_multiple) * pad_multiple)

    ww = np.full((S, n_pad), wps, np.int32)
    wd = np.full((S, n_pad), num_docs, np.int32)
    wv = np.zeros((S, n_pad), np.float32)
    for s in range(S):
        lo, hi = bounds_n[s], bounds_n[s + 1]
        ww[s, : hi - lo] = words[lo:hi] - bounds_w[s]
        wd[s, : hi - lo] = docs[lo:hi]
        wv[s, : hi - lo] = vals[lo:hi]
    sh = NamedSharding(mesh, P(AXIS))
    put = lambda x: jax.device_put(x, sh)
    return WordSharded(
        w_word=put(ww),
        w_doc=put(wd),
        w_val=put(wv),
        vocab=vocab,
        num_docs=num_docs,
        words_per_shard=wps,
        nnz=n,
        word_start=bounds_w[:-1],
    )


def sharded_thresholds(
    ws: WordSharded, avg_doc_sz: float, nz_docs: int, num_topics: int, hyper,
    mesh: Mesh,
) -> Tuple[np.ndarray, int]:
    """Per-word zeta cutoffs, word-parallel with zero communication
    (assembly of the small per-word outputs happens host-side).
    Returns (zetas (vocab,), new_nnz)."""
    from .thresholds import freq_bound, _zeta_from_hist

    F = freq_bound(avg_doc_sz)
    count_gr = hyper.count_gr(nz_docs, num_topics)
    count_eq = hyper.count_eq(nz_docs, num_topics)
    wps = ws.words_per_shard

    def f(w_word, w_val):
        w = w_word[0]
        v = w_val[0]
        n = w.shape[0]
        chunk = max(min(1 << 18, n), 1)
        while n % chunk:
            chunk //= 2
        r = jnp.clip(jnp.floor(v + 0.5).astype(jnp.int32), 0, F)
        nbanks = (F + 1 + 127) // 128

        def body(acc, args):
            wi, ri = args
            row = wi * nbanks + ri // 128
            # int32 bins (see thresholds._hist_banked: f32 saturates at
            # 2^24)
            return acc.at[row].add(
                jax.nn.one_hot(ri % 128, 128, dtype=jnp.int32)
            ), None

        init = _pvary(jnp.zeros(((wps + 1) * nbanks, 128), jnp.int32))
        hist, _ = jax.lax.scan(
            body,
            init,
            (w.reshape(n // chunk, chunk), r.reshape(n // chunk, chunk)),
        )
        hist = hist.reshape(wps + 1, nbanks * 128)[:wps, : F + 1]
        hist = hist.at[:, 0].set(0)
        zeta, nnz_w = _zeta_from_hist(
            hist, count_gr, count_eq, jnp,
            few_drop=hyper.few_samples_threshold_drop,
            bad_drop=hyper.bad_threshold_drop,
        )
        return zeta[None].astype(jnp.float32), nnz_w[None]

    zl, nnzl = _sm(
        ("model_thresholds", wps, F, count_gr, count_eq,
         hyper.few_samples_threshold_drop, hyper.bad_threshold_drop),
        lambda: f, mesh, (P(AXIS), P(AXIS)), (P(AXIS), P(AXIS)),
    )(ws.w_word, ws.w_val)
    zl = np.asarray(zl)
    nnzl = np.asarray(nnzl)
    zetas = np.ones(ws.vocab, np.float32)
    new_nnz = 0
    bounds = np.concatenate([ws.word_start, [ws.vocab]])
    for s in range(ws.num_shards):
        width = int(bounds[s + 1] - bounds[s])
        zetas[bounds[s] : bounds[s + 1]] = zl[s][:width]
        new_nnz += int(nnzl[s][:width].sum())
    return zetas, new_nnz


def sharded_rth_highest(
    ws: WordSharded,
    cluster_of_doc: np.ndarray,
    cluster_sizes: np.ndarray,
    num_topics: int,
    r: int,
    mesh: Mesh,
) -> np.ndarray:
    """Catchword statistics, word-parallel: each shard sorts only its own
    word range (S-fold smaller sorts than the single-device path).
    Returns thresholds (num_topics, vocab)."""
    assert r >= 1
    k = num_topics
    wps = ws.words_per_shard
    cl = jnp.asarray(
        np.concatenate([cluster_of_doc.astype(np.int32), [-1]])
    )
    csz = jnp.asarray(cluster_sizes.astype(np.int32))

    def f(w_word, w_doc, w_val, cl, csz):
        w = w_word[0]
        d = w_doc[0]
        v = w_val[0]
        n = w.shape[0]
        c = cl[d]
        in_cluster = c >= 0
        key = jnp.where(in_cluster, w * k + jnp.maximum(c, 0), wps * k).astype(
            jnp.int32
        )
        skey, sneg = jax.lax.sort((key, -v), num_keys=2, is_stable=False)
        sval = -sneg

        chunk = max(min(1 << 18, n), 1)
        while n % chunk:
            chunk //= 2

        def body(acc, args):
            kk, ic = args
            # int32 accumulator (see catchwords._count_scan: f32 one-hot
            # adds saturate at 2^24 entries per group)
            g = jax.nn.one_hot(kk % k, k, dtype=jnp.int32) * ic[:, None]
            return acc.at[kk // k].add(g), None

        init = _pvary(jnp.zeros((wps + 1, k), jnp.int32))
        cm, _ = jax.lax.scan(
            body,
            init,
            (
                key.reshape(n // chunk, chunk),
                in_cluster.astype(jnp.int32).reshape(n // chunk, chunk),
            ),
        )
        counts = jnp.concatenate(
            [cm[:wps].reshape(wps * k), jnp.zeros((k,), jnp.int32)]
        )
        starts = jnp.cumsum(counts) - counts
        rth = sval[jnp.clip(starts + (r - 1), 0, n - 1)]
        gmin = sval[jnp.clip(starts + counts - 1, 0, n - 1)]
        counts2 = counts[: wps * k].reshape(wps, k)
        rth = rth[: wps * k].reshape(wps, k)
        gmin = gmin[: wps * k].reshape(wps, k)
        thr = jnp.where(counts2 > r, rth, 0.0)
        degenerate = (
            (counts2 <= r) & (r >= csz[None, :]) & (counts2 == csz[None, :])
            & (csz[None, :] > 0)
        )
        thr = jnp.where(degenerate, gmin, thr)
        return thr.T[None].astype(jnp.float32)  # (1, k, wps)

    tl = _sm(
        ("rth_highest", wps, k, r), lambda: f, mesh,
        (P(AXIS), P(AXIS), P(AXIS), P(), P()), P(AXIS),
    )(ws.w_word, ws.w_doc, ws.w_val, cl, csz)
    tl = np.asarray(tl)  # (S, k, wps)
    out = np.zeros((k, ws.vocab), np.float32)
    bounds = np.concatenate([ws.word_start, [ws.vocab]])
    for s in range(ws.num_shards):
        width = int(bounds[s + 1] - bounds[s])
        out[:, bounds[s] : bounds[s + 1]] = tl[s][:, :width]
    return out


def _local_bt_x(word, doc, val, X, dps):
    g = jnp.take(X, word[0], axis=0, fill_value=0.0) * val[0][:, None]
    out = jax.ops.segment_sum(g, doc[0], num_segments=dps + 1)
    return out[None, :dps]


def _local_b_y_partial(word, doc, val, Y, vocab):
    g = jnp.take(Y, doc[0], axis=0, fill_value=0.0) * val[0][:, None]
    out = jax.ops.segment_sum(g, word[0], num_segments=vocab + 1)
    return out[:vocab]


def sharded_bt_x(ssp: ShardedDocSparse, X: jax.Array, mesh: Mesh) -> jax.Array:
    """(S, docs_per_shard, width), doc-sharded; X replicated."""
    dps = ssp.docs_per_shard

    def f(word, doc, val, X):
        return _local_bt_x(word, doc, val, X, dps)

    return _sm(
        ("bt_x", dps), lambda: f, mesh,
        (P(AXIS), P(AXIS), P(AXIS), P()), P(AXIS),
    )(ssp.d_word, ssp.d_doc, ssp.d_val, X)


def sharded_b_y(ssp: ShardedDocSparse, Y: jax.Array, mesh: Mesh) -> jax.Array:
    """Y: (S, docs_per_shard, width) doc-sharded -> (vocab, width)
    replicated via psum over the mesh."""
    vocab = ssp.vocab

    def f(word, doc, val, Y):
        part = _local_b_y_partial(word, doc, val, Y[0], vocab)
        return jax.lax.psum(part, AXIS)

    return _sm(
        ("b_y", vocab), lambda: f, mesh,
        (P(AXIS), P(AXIS), P(AXIS), P(AXIS)), P(),
    )(ssp.w_word, ssp.w_doc, ssp.w_val, Y)


def sharded_gram_x(ssp: ShardedDocSparse, X: jax.Array, mesh: Mesh) -> jax.Array:
    """(B B^T) X with one psum per product — the multi-chip eigensolver
    operator."""
    vocab, dps = ssp.vocab, ssp.docs_per_shard

    def f(dw, dd, dv, ww, wd, wv, X):
        local = _local_bt_x(dw, dd, dv, X, dps)  # (1, dps, c)
        part = _local_b_y_partial(ww, wd, wv, local[0], vocab)
        return jax.lax.psum(part, AXIS)

    return _sm(
        ("gram_x", vocab, dps), lambda: f, mesh,
        (P(AXIS),) * 6 + (P(),), P(),
    )(ssp.d_word, ssp.d_doc, ssp.d_val, ssp.w_word, ssp.w_doc, ssp.w_val, X)


def sharded_train_step(ssp: ShardedDocSparse, mesh: Mesh, num_topics: int):
    """One composite, jittable 'training step' exercising every collective
    pattern of the pipeline on the mesh: a Krylov operator application
    (psum), per-shard k-means assignment (local), center/count update
    (psum), and a threshold histogram (psum). Returns a jitted fn and
    example args."""
    vocab, dps = ssp.vocab, ssp.docs_per_shard
    k = num_topics

    def step(ssp, X, centers):
        # (a) eigensolver operator
        Y = sharded_gram_x(ssp, X, mesh)

        # (b) k-means: assignment local to each doc shard, update psum'd
        def assign_update(dw, dd, dv, ww, wd, wv, centers):
            dots = _local_bt_x(dw, dd, dv, centers.T, dps)[0]  # (dps, k)
            l2 = jax.ops.segment_sum(
                dv[0] * dv[0], dd[0], num_segments=dps + 1
            )[:dps]
            c_l2 = jnp.sum(centers * centers, axis=1)
            dist = l2[:, None] + c_l2[None, :] - 2.0 * dots
            assign = jnp.argmin(dist, axis=1).astype(jnp.int32)
            onehot = jax.nn.one_hot(assign, k, dtype=jnp.float32)
            sums = _local_b_y_partial(ww, wd, wv, onehot, vocab)
            sums = jax.lax.psum(sums, AXIS)  # (vocab, k)
            counts = jax.lax.psum(jnp.sum(onehot, axis=0), AXIS)
            new_centers = jnp.where(
                counts[None, :] > 0, sums / counts[None, :], 0.0
            ).T
            return assign[None], new_centers

        assign, new_centers = jax.shard_map(
            assign_update,
            mesh=mesh,
            in_specs=(P(AXIS),) * 6 + (P(),),
            out_specs=(P(AXIS), P()),
        )(ssp.d_word, ssp.d_doc, ssp.d_val, ssp.w_word, ssp.w_doc, ssp.w_val,
          centers)

        # (c) threshold histogram over word ids, psum'd
        def hist(dw):
            h = jax.ops.segment_sum(
                jnp.ones_like(dw[0], jnp.float32), dw[0],
                num_segments=vocab + 1,
            )
            return jax.lax.psum(h[:vocab], AXIS)

        h = jax.shard_map(hist, mesh=mesh, in_specs=(P(AXIS),), out_specs=P())(
            ssp.d_word
        )
        return Y, assign, new_centers, h

    return _cached_step(("train_step", vocab, dps, k, mesh),
                        lambda: jax.jit(step))


# ---------------------------------------------------------------------------
# Full sharded training pipeline primitives: B construction,
# doc-row compaction/expansion, full-space Lloyd's, doc-topic mass.
# Together with sharded_thresholds / sharded_rth_highest / sharded_gram_x
# above, these let Trainer.train() run every SpMM-heavy stage under
# shard_map on the mesh while k- and vocab-dimension state stays replicated
# (the mesh translation of the reference's shared-memory layout,
# SURVEY.md §5.7-5.8).
# ---------------------------------------------------------------------------


def _doc_flat_index(ssp: ShardedDocSparse) -> np.ndarray:
    """Flat (shard*dps + local) positions of the valid docs, in global doc
    order."""
    dps = ssp.docs_per_shard
    valid = ssp.valid_per_shard()
    if len(valid) == 0:
        return np.zeros((0,), np.int32)
    return np.concatenate(
        [s * dps + np.arange(v, dtype=np.int64) for s, v in enumerate(valid)]
    ).astype(np.int32)


def compact_doc_rows(x: jax.Array, ssp: ShardedDocSparse) -> jax.Array:
    """(S, dps, w) doc-sharded -> (num_valid_docs, w) global doc-major
    (gathered across shards; the result is small k-width state)."""
    S, dps = x.shape[0], x.shape[1]
    idx = jnp.asarray(_doc_flat_index(ssp))
    return jnp.take(x.reshape(S * dps, *x.shape[2:]), idx, axis=0)


def pad_doc_rows(W: jax.Array, ssp: ShardedDocSparse, mesh: Mesh) -> jax.Array:
    """Inverse of compact_doc_rows: global (num_valid_docs, w) doc-major ->
    (S, dps, w) doc-sharded layout (invalid slots zero)."""
    S, dps = ssp.num_shards, ssp.docs_per_shard
    idx = jnp.asarray(_doc_flat_index(ssp))
    out = (
        jnp.zeros((S * dps,) + tuple(W.shape[1:]), W.dtype)
        .at[idx]
        .set(jnp.asarray(W))
    )
    return jax.device_put(
        out.reshape((S, dps) + tuple(W.shape[1:])), NamedSharding(mesh, P(AXIS))
    )


def sharded_threshold_and_copy(
    ssp: ShardedDocSparse,
    zetas,
    mesh: Mesh,
    sample_rate: Optional[float] = None,
    key: Optional[jax.Array] = None,
    pad_multiple: int = 1 << 13,
) -> Tuple[ShardedDocSparse, np.ndarray]:
    """Doc-sharded B construction (bmatrix.threshold_and_copy semantics:
    keep entries with round(val) >= zeta[word], set value sqrt(zeta), drop
    empty docs, renumber LOCALLY per shard). Returns (B, original_cols)
    with original_cols in global ascending doc order, identical to the
    single-device path (shards are contiguous doc ranges)."""
    V, dps = ssp.vocab, ssp.docs_per_shard
    S, D = ssp.num_shards, ssp.num_docs
    zetas = jnp.asarray(zetas, jnp.float32)

    sel_p = None
    if sample_rate is not None:
        assert key is not None
        # Importance sampling needs the GLOBAL pivot over per-doc weights
        # (src/sparseMatrix.cpp:1383-1417): weights reduce locally per
        # shard, the tiny (D,) dice/pivot computation is replicated.
        def wt_f(word, doc, val, zetas):
            w, d, v = word[0], doc[0], val[0]
            z = jnp.concatenate([zetas, jnp.full((1,), jnp.inf, jnp.float32)])
            keep = jnp.floor(v + 0.5) >= z[w]
            zw = jnp.concatenate([zetas, jnp.zeros((1,), jnp.float32)])
            wt = jax.ops.segment_sum(
                jnp.where(keep, zw[w], 0.0), d, num_segments=dps + 1
            )[:dps]
            return wt[None]

        wt = _sm(
            ("tc_weights", dps), lambda: wt_f, mesh,
            (P(AXIS),) * 3 + (P(),), P(AXIS),
        )(ssp.d_word, ssp.d_doc, ssp.d_val, zetas)
        w_glob = compact_doc_rows(wt[..., None], ssp)[:, 0]  # (D,)
        u = jax.random.uniform(key, (D,), dtype=jnp.float32)
        dice = jnp.where(
            w_glob > 0.0, jnp.power(u, 1.0 / jnp.maximum(w_glob, 1e-30)), 0.0
        )
        pivot = jnp.sort(dice)[::-1][int(sample_rate * D)]
        sel = dice >= pivot  # (D,) global
        sel_np = np.asarray(sel)
        sel_pad = np.zeros((S, dps + 1), bool)
        flat = _doc_flat_index(ssp)
        sel_pad.reshape(-1)[
            (flat // dps) * (dps + 1) + (flat % dps)
        ] = sel_np
        sel_p = jax.device_put(sel_pad, NamedSharding(mesh, P(AXIS)))

    no_sel = jax.device_put(
        np.ones((S, dps + 1), bool), NamedSharding(mesh, P(AXIS))
    )
    if sel_p is None:
        sel_p = no_sel

    # Phase 1: per-shard occupancy + kept-entry counts (host sync fixes
    # the static compacted size).
    def occ_f(word, doc, val, sel, zetas):
        w, d, v = word[0], doc[0], val[0]
        z = jnp.concatenate([zetas, jnp.full((1,), jnp.inf, jnp.float32)])
        keep = (jnp.floor(v + 0.5) >= z[w]) & sel[0][d]
        occ = (
            jax.ops.segment_sum(
                keep.astype(jnp.int32), d, num_segments=dps + 1
            )[:dps]
            > 0
        )
        return occ[None], jnp.sum(keep.astype(jnp.int32))[None]

    occ, kept = _sm(
        ("tc_occupancy", dps), lambda: occ_f, mesh,
        (P(AXIS),) * 4 + (P(),), (P(AXIS), P(AXIS)),
    )(ssp.d_word, ssp.d_doc, ssp.d_val, sel_p, zetas)
    occ = np.array(occ)  # (S, dps), writable copy
    kept = np.asarray(kept)  # (S,)
    valid_A = ssp.valid_per_shard()
    for s in range(S):
        occ[s, valid_A[s]:] = False
    nzd = occ.sum(axis=1).astype(np.int64)  # valid B docs per shard
    doc_base = np.arange(S, dtype=np.int64)[:, None] * dps
    original_cols = np.concatenate(
        [doc_base[s] + np.flatnonzero(occ[s]) for s in range(S)]
    ).astype(np.int32) if S else np.zeros((0,), np.int32)

    dps_B = int(max(((int(nzd.max(initial=0)) + 7) // 8) * 8, 8))
    n_pad_B = int(
        max(pad_multiple, -(-int(kept.max(initial=0)) // pad_multiple) * pad_multiple)
    )

    # Local renumber map per shard: (S, dps + 1), pad doc id -> dps_B spill.
    renum = np.full((S, dps + 1), dps_B, np.int32)
    for s in range(S):
        renum[s, :dps][occ[s]] = np.arange(nzd[s], dtype=np.int32)
    renum_d = jax.device_put(renum, NamedSharding(mesh, P(AXIS)))

    # Phase 2: stable compaction in both sort orders.
    def compact_f(word, doc, val, sel, renum, zetas):
        w, d, v = word[0], doc[0], val[0]
        z = jnp.concatenate([zetas, jnp.full((1,), jnp.inf, jnp.float32)])
        keep = (jnp.floor(v + 0.5) >= z[w]) & sel[0][d]
        pos = jnp.where(keep, jnp.cumsum(keep.astype(jnp.int32)) - 1, n_pad_B)
        out_w = (
            jnp.full((n_pad_B,), V, jnp.int32).at[pos].set(w, mode="drop")
        )
        out_d = (
            jnp.full((n_pad_B,), dps_B, jnp.int32)
            .at[pos]
            .set(renum[0][d], mode="drop")
        )
        sz = jnp.concatenate([jnp.sqrt(zetas), jnp.zeros((1,), jnp.float32)])
        out_v = jnp.zeros((n_pad_B,), jnp.float32).at[pos].set(
            sz[w], mode="drop"
        )
        return out_w[None], out_d[None], out_v[None]

    cmp = _sm(
        ("tc_compact", V, dps_B, n_pad_B), lambda: compact_f, mesh,
        (P(AXIS),) * 5 + (P(),), (P(AXIS),) * 3,
    )
    dw, dd, dv = cmp(
        ssp.d_word, ssp.d_doc, ssp.d_val, sel_p, renum_d, zetas
    )
    ww, wd, wv = cmp(
        ssp.w_word, ssp.w_doc, ssp.w_val, sel_p, renum_d, zetas
    )

    prefix = np.concatenate([[0], np.cumsum(nzd)[:-1]]).astype(np.int32)
    B = ShardedDocSparse(
        d_word=dw,
        d_doc=dd,
        d_val=dv,
        w_word=ww,
        w_doc=wd,
        w_val=wv,
        doc_offset=jax.device_put(
            prefix[:, None], NamedSharding(mesh, P(AXIS))
        ),
        vocab=V,
        docs_per_shard=dps_B,
        num_docs=int(nzd.sum()),
        nnz=int(kept.sum()),
        valid_docs=tuple(int(x) for x in nzd),
    )
    return B, original_cols


def sharded_doc_l2sq(ssp, mesh: Mesh) -> jax.Array:
    """Per-doc squared l2 norms, doc-sharded (S, dps). Accepts the COO or
    the factored-hybrid sharded layout."""
    dps = ssp.docs_per_shard

    if isinstance(ssp, ShardedHybrid):
        from .hybrid import _head_dot

        V = ssp.vocab
        s2 = ssp.row_scale * ssp.row_scale
        s2p = jnp.concatenate([s2, jnp.zeros((1,), jnp.float32)])
        s2h = jnp.take(s2, ssp.head_words, axis=0)  # (R,) head row scales

        def fh(head, td_w, td_o, s2h, s2p):
            head_l2 = _head_dot(head[0], s2h[:, None], transpose=True)[
                :, 0]  # (dps,)
            v2 = s2p[jnp.minimum(td_w[0], V)]
            octs = jnp.sum(v2.reshape(-1, 8), axis=1)
            tail = _pvary(jnp.zeros((dps + 1,), jnp.float32)).at[
                td_o[0]
            ].add(octs, indices_are_sorted=True)
            return (head_l2 + tail[:dps])[None]

        return _sm(
            ("h_doc_l2sq", dps, V), lambda: fh, mesh,
            (P(AXIS),) * 3 + (P(), P()), P(AXIS),
        )(ssp.head, ssp.td_word, ssp.td_odoc, s2h, s2p)

    def f(doc, val):
        out = jax.ops.segment_sum(
            val[0] * val[0], doc[0], num_segments=dps + 1
        )[:dps]
        return out[None]

    return _sm(
        ("doc_l2sq", dps), lambda: f, mesh, (P(AXIS), P(AXIS)), P(AXIS),
    )(ssp.d_doc, ssp.d_val)


def make_sharded_h_lloyds_step(h, mesh: Mesh, k: int):
    """Hybrid-layout form of make_sharded_lloyds_step (same collective
    pattern; head products as dense matmuls)."""
    vocab, dps = h.vocab, h.docs_per_shard

    def step(h, centers, docs_l2, nzd):
        rs, hw = h.row_scale, h.head_words

        def f(head, td_w, td_o, tw_d, tw_o, dl2, nzd_s, centers):
            dots = _local_h_bt_x(head[0], td_w[0], td_o[0], centers.T,
                                 rs, hw, vocab, dps)
            c_l2 = jnp.sum(centers * centers, axis=1)
            dist = dl2[0][:, None] + c_l2[None, :] - 2.0 * dots
            assign = jnp.argmin(dist, axis=1).astype(jnp.int32)
            valid = (
                jax.lax.broadcasted_iota(jnp.int32, (dps, 1), 0)[:, 0]
                < nzd_s[0, 0]
            )
            onehot = jax.nn.one_hot(assign, k, dtype=jnp.float32)
            onehot = onehot * valid[:, None].astype(jnp.float32)
            sums = jax.lax.psum(
                _local_h_b_y_partial(head[0], tw_d[0], tw_o[0], onehot,
                                     rs, hw, vocab),
                AXIS,
            )
            counts = jax.lax.psum(jnp.sum(onehot, axis=0), AXIS)
            new_centers = jnp.where(
                counts[None, :] > 0, sums / counts[None, :], 0.0
            ).T
            assign = jnp.where(valid, assign, -1)
            return assign[None], new_centers

        return jax.shard_map(
            f,
            mesh=mesh,
            in_specs=(P(AXIS),) * 7 + (P(),),
            out_specs=(P(AXIS), P()),
        )(
            h.head, h.td_word, h.td_odoc, h.tw_doc, h.tw_oword,
            docs_l2, nzd, centers,
        )

    return _cached_step(("h_lloyds_step", vocab, dps, k, mesh),
                        lambda: jax.jit(step))


def make_sharded_lloyds_step(ssp: ShardedDocSparse, mesh: Mesh, k: int):
    """One fused full-space Lloyd's iteration on the mesh: local distance +
    argmin per doc shard, psum'd center/count update (the collective form
    of src/sparseMatrix.cpp:1586-1677). Returns a jitted step
    (ssp, centers, docs_l2, nzd) -> (assign (S, dps) with -1 padding,
    new centers (k, vocab) replicated)."""
    vocab, dps = ssp.vocab, ssp.docs_per_shard

    def step(ssp, centers, docs_l2, nzd):
        def f(dw, dd, dv, ww, wd, wv, dl2, nzd_s, centers):
            dots = _local_bt_x(dw, dd, dv, centers.T, dps)[0]  # (dps, k)
            c_l2 = jnp.sum(centers * centers, axis=1)
            dist = dl2[0][:, None] + c_l2[None, :] - 2.0 * dots
            assign = jnp.argmin(dist, axis=1).astype(jnp.int32)
            valid = (
                jax.lax.broadcasted_iota(jnp.int32, (dps, 1), 0)[:, 0]
                < nzd_s[0, 0]
            )
            onehot = jax.nn.one_hot(assign, k, dtype=jnp.float32)
            onehot = onehot * valid[:, None].astype(jnp.float32)
            sums = jax.lax.psum(
                _local_b_y_partial(ww, wd, wv, onehot, vocab), AXIS
            )
            counts = jax.lax.psum(jnp.sum(onehot, axis=0), AXIS)
            new_centers = jnp.where(
                counts[None, :] > 0, sums / counts[None, :], 0.0
            ).T
            assign = jnp.where(valid, assign, -1)
            return assign[None], new_centers

        return jax.shard_map(
            f,
            mesh=mesh,
            in_specs=(P(AXIS),) * 8 + (P(),),
            out_specs=(P(AXIS), P()),
        )(
            ssp.d_word, ssp.d_doc, ssp.d_val,
            ssp.w_word, ssp.w_doc, ssp.w_val,
            docs_l2, nzd, centers,
        )

    return _cached_step(("lloyds_step", vocab, dps, k, mesh),
                        lambda: jax.jit(step))


def sharded_run_lloyds_full(
    ssp,
    centers: jax.Array,
    max_reps: int,
    mesh: Mesh,
    timer=None,
) -> Tuple[jax.Array, np.ndarray]:
    """Full-space Lloyd's on the mesh to membership convergence. Accepts
    the COO or factored-hybrid sharded layout. Returns (centers
    (k, vocab) replicated, assign: GLOBAL (num_docs,) host array in
    B-doc order)."""
    k = centers.shape[0]
    docs_l2 = sharded_doc_l2sq(ssp, mesh)
    nzd = jax.device_put(
        np.asarray(ssp.valid_per_shard(), np.int32)[:, None],
        NamedSharding(mesh, P(AXIS)),
    )
    if isinstance(ssp, ShardedHybrid):
        step = make_sharded_h_lloyds_step(ssp, mesh, k)
    else:
        step = make_sharded_lloyds_step(ssp, mesh, k)
    prev = None
    assign = None
    for rep in range(max_reps):
        assign, centers = step(ssp, centers, docs_l2, nzd)
        a = np.asarray(assign)
        if prev is not None and np.array_equal(a, prev):
            if timer is not None:
                timer.diag(f"sharded full lloyds converged at rep {rep}")
            break
        prev = a
    flat = _doc_flat_index(ssp)
    return centers, np.asarray(assign).reshape(-1)[flat]


def sharded_doc_topic_mass(
    ssp: ShardedDocSparse, cw_topic: jax.Array, num_topics: int, mesh: Mesh
) -> jax.Array:
    """Per-doc catchword-topic mass, doc-sharded (S, dps, k) (the sharded
    form of topic_model.doc_topic_mass)."""
    dps, k = ssp.docs_per_shard, num_topics

    def f(dw, dd, dv, cwt):
        t = jnp.concatenate([cwt, jnp.full((1,), -1, jnp.int32)])[dw[0]]
        is_cw = t >= 0
        ddd = jnp.where(is_cw, dd[0], dps)
        tt = jnp.maximum(t, 0)
        # flat scatter index (see hybrid.py on 2D-scatter index layouts)
        acc = jnp.zeros(((dps + 1) * k,), jnp.float32).at[
            ddd * jnp.int32(k) + tt
        ].add(jnp.where(is_cw, dv[0], 0.0))
        return acc.reshape(dps + 1, k)[None, :dps]

    return _sm(
        ("doc_topic_mass", dps, k), lambda: f, mesh,
        (P(AXIS),) * 3 + (P(),), P(AXIS),
    )(ssp.d_word, ssp.d_doc, ssp.d_val, cw_topic)


def sharded_spmm_flops(ssp: ShardedDocSparse, width: int) -> int:
    """FLOPs of one sharded bt_x or b_y (2*nnz*width; matches
    sparse.spmm_flops for the op counter)."""
    return 2 * ssp.nnz * width


# ---------------------------------------------------------------------------
# Sharded value-factored hybrid layout: the optimized SpMM engine
# (hybrid.py's bf16 binary head + octet tails) on the mesh. Head words are
# selected GLOBALLY (psum'd counts) so the psum'd B·Y semantics hold; each
# shard stores its local (R, docs_per_shard) head slab and its local tails
# padded to the cross-shard maximum (shard_map needs uniform shapes).
# ---------------------------------------------------------------------------


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ShardedHybrid:
    """Doc-sharded factored hybrid of a thresholded B: every nonzero of
    row w equals row_scale[w] (sqrt zeta)."""

    head_words: jax.Array  # (R,) int32, replicated
    head: jax.Array  # (S, R, dps) bfloat16 binary, doc-sharded
    td_word: jax.Array  # (S, Nt) doc-sorted tail word ids (pad vocab)
    td_odoc: jax.Array  # (S, Nt/8) per-octet LOCAL doc ids (pad dps)
    tw_doc: jax.Array  # (S, Nw) word-sorted tail LOCAL doc ids (pad dps)
    tw_oword: jax.Array  # (S, Nw/8) per-octet word ids (pad vocab)
    row_scale: jax.Array  # (vocab,) float32, replicated
    vocab: int = dataclasses.field(metadata=dict(static=True))
    docs_per_shard: int = dataclasses.field(metadata=dict(static=True))
    num_docs: int = dataclasses.field(metadata=dict(static=True))
    nnz: int = dataclasses.field(metadata=dict(static=True))
    valid_docs: Optional[Tuple[int, ...]] = dataclasses.field(
        default=None, metadata=dict(static=True)
    )

    @property
    def num_shards(self) -> int:
        return self.head.shape[0]

    @property
    def num_head(self) -> int:
        return self.head_words.shape[0]

    def valid_per_shard(self) -> np.ndarray:
        if self.valid_docs is not None:
            return np.asarray(self.valid_docs)
        S, dps = self.num_shards, self.docs_per_shard
        return np.clip(
            self.num_docs - np.arange(S) * dps, 0, dps
        ).astype(np.int64)


def shard_hybrid(
    ssp: ShardedDocSparse,
    row_scale,
    mesh: Mesh,
    head_budget_bytes: int,
    chunk: int = 1 << 18,
) -> ShardedHybrid:
    """Build the sharded factored layout from a (post-threshold) sharded
    B. Mirrors hybrid.to_hybrid per shard with a GLOBAL head selection."""
    from .hybrid import _oseg_from_offsets, _pad8_plan, max_head_rows

    V, dps = ssp.vocab, ssp.docs_per_shard
    S = ssp.num_shards
    row_scale = jnp.asarray(row_scale, jnp.float32)

    # Global per-word counts (psum) -> head selection, replicated.
    def counts_f(ww):
        c = jax.ops.segment_sum(
            (ww[0] < V).astype(jnp.int32), ww[0], num_segments=V + 1,
            indices_are_sorted=True,
        )[:V]
        return jax.lax.psum(c, AXIS)

    counts = _sm(
        ("sh_counts", V), lambda: counts_f, mesh, (P(AXIS),), P(),
    )(ssp.w_word)
    num_head = int(min(
        V, max(8, head_budget_bytes // max(2 * dps * S, 1)),
        max_head_rows(dps),
    ))
    _, head_words = jax.lax.top_k(counts, num_head)
    head_words = jnp.sort(head_words).astype(jnp.int32)
    is_head = jnp.zeros((V + 1,), bool).at[head_words].set(True)
    rankx = jnp.full((V + 1,), -1, jnp.int32).at[head_words].set(
        jnp.arange(num_head, dtype=jnp.int32)
    )

    # Plan pass: per-shard padded tail sizes (host max fixes statics).
    def plan_f(dw, dd, ww, ih):
        mask_d = (dw[0] < V) & ~ih[dw[0]]
        mask_w = (ww[0] < V) & ~ih[ww[0]]
        _, padded_d, _ = _pad8_plan(mask_d, dd[0], dps)
        _, padded_w, _ = _pad8_plan(mask_w, ww[0], V)
        return (jnp.sum(padded_d)[None], jnp.sum(padded_w)[None],
                jnp.sum(mask_d.astype(jnp.int32))[None])

    nts, nws, tails = _sm(
        ("sh_plan", V, dps), lambda: plan_f, mesh,
        (P(AXIS),) * 3 + (P(),), (P(AXIS),) * 3,
    )(ssp.d_word, ssp.d_doc, ssp.w_word, is_head)
    Nt = int(np.asarray(nts).max(initial=0))
    Nw = int(np.asarray(nws).max(initial=0))
    tail_nnz = int(np.asarray(tails).sum())
    Nt_pad = max(((Nt + chunk - 1) // chunk) * chunk, chunk)
    Nw_pad = max(((Nw + chunk - 1) // chunk) * chunk, chunk)

    # Build pass: per-shard head slab + compacted tails at uniform shapes.
    def build_f(dw, dd, ww, wd, ih, rkx):
        w, d = dw[0], dd[0]
        r = rkx[w]
        hmask = (w < V) & (r >= 0)
        rr = jnp.where(hmask, r, num_head)
        cc = jnp.where(hmask, d, dps)
        flat = rr * jnp.int32(dps + 1) + cc
        H = jnp.zeros(((num_head + 1) * (dps + 1),), jnp.bfloat16)
        H = H.at[flat].set(jnp.bfloat16(1.0))
        H = H.reshape(num_head + 1, dps + 1)[:num_head, :dps]

        mask_d = (w < V) & ~ih[w]
        pos_d, _, off_d = _pad8_plan(mask_d, d, dps)
        td_w = jnp.full((Nt_pad,), V, jnp.int32).at[pos_d].set(
            w, mode="drop"
        )
        td_o = _oseg_from_offsets(off_d, Nt_pad)

        wl, dl = ww[0], wd[0]
        mask_w = (wl < V) & ~ih[wl]
        pos_w, _, off_w = _pad8_plan(mask_w, wl, V)
        tw_d = jnp.full((Nw_pad,), dps, jnp.int32).at[pos_w].set(
            dl, mode="drop"
        )
        tw_o = _oseg_from_offsets(off_w, Nw_pad)
        return H[None], td_w[None], td_o[None], tw_d[None], tw_o[None]

    head, td_word, td_odoc, tw_doc, tw_oword = _sm(
        ("sh_build", V, dps, num_head, Nt_pad, Nw_pad), lambda: build_f,
        mesh, (P(AXIS),) * 4 + (P(), P()), (P(AXIS),) * 5,
    )(ssp.d_word, ssp.d_doc, ssp.w_word, ssp.w_doc, is_head, rankx)

    return ShardedHybrid(
        head_words=head_words,
        head=head,
        td_word=td_word,
        td_odoc=td_odoc,
        tw_doc=tw_doc,
        tw_oword=tw_oword,
        row_scale=row_scale,
        vocab=V,
        docs_per_shard=dps,
        num_docs=ssp.num_docs,
        nnz=ssp.nnz,
        valid_docs=ssp.valid_docs,
    )


def _local_h_bt_x(head, td_w, td_o, X, row_scale, head_words,
                  vocab: int, dps: int):
    """Per-shard B^T X block (local docs; X replicated). All operands are
    the shard-local (unbatched) arrays; row_scale/head_words replicated."""
    from .hybrid import _head_dot, _tail_gather_octsum

    Xs = X[:vocab] * row_scale[:, None]
    Xh = jnp.take(Xs, head_words, axis=0)  # (R, W)
    out_head = _head_dot(head, Xh, transpose=True)  # (dps, W)
    chunk = min(1 << 18, td_w.shape[0])
    init = _pvary(jnp.zeros((dps + 1, X.shape[1]), X.dtype))
    tail = _tail_gather_octsum(td_w, None, td_o, Xs, dps, chunk, init=init)
    return tail[:dps] + out_head


def _local_h_b_y_partial(head, tw_d, tw_o, Y, row_scale, head_words,
                         vocab: int):
    """Per-shard partial of B Y (psum across shards recovers the full
    (vocab, W) product). Y is the shard's local (dps, W) block."""
    from .hybrid import _head_dot, _tail_gather_octsum

    V = vocab
    chunk = min(1 << 18, tw_d.shape[0])
    init = _pvary(jnp.zeros((V + 1, Y.shape[1]), Y.dtype))
    out = _tail_gather_octsum(tw_d, None, tw_o, Y, V, chunk, init=init)[:V]
    out = out * row_scale[:, None]
    head_out = _head_dot(head, Y, transpose=False)
    head_out = head_out * jnp.take(row_scale, head_words)[:, None]
    return out.at[head_words].add(head_out)


def sharded_h_bt_x(h: ShardedHybrid, X: jax.Array, mesh: Mesh) -> jax.Array:
    """(S, dps, W) doc-sharded B^T X; X replicated."""
    V, dps = h.vocab, h.docs_per_shard

    def f(head, td_w, td_o, X, rs, hw):
        return _local_h_bt_x(head[0], td_w[0], td_o[0], X, rs, hw,
                             V, dps)[None]

    return _sm(
        ("h_bt_x", V, dps), lambda: f, mesh,
        (P(AXIS),) * 3 + (P(), P(), P()), P(AXIS),
    )(h.head, h.td_word, h.td_odoc, X, h.row_scale, h.head_words)


def sharded_h_b_y(h: ShardedHybrid, Y: jax.Array, mesh: Mesh) -> jax.Array:
    """Y: (S, dps, W) doc-sharded -> (vocab, W) replicated via psum."""
    V = h.vocab

    def f(head, tw_d, tw_o, Y, rs, hw):
        part = _local_h_b_y_partial(head[0], tw_d[0], tw_o[0], Y[0],
                                    rs, hw, V)
        return jax.lax.psum(part, AXIS)

    return _sm(
        ("h_b_y", V), lambda: f, mesh,
        (P(AXIS),) * 4 + (P(), P()), P(),
    )(h.head, h.tw_doc, h.tw_oword, Y, h.row_scale, h.head_words)


def sharded_h_gram_x(h: ShardedHybrid, X: jax.Array, mesh: Mesh) -> jax.Array:
    """(B B^T) X on the mesh with the factored-hybrid engine — head
    products as dense matmuls, one psum per product."""
    V, dps = h.vocab, h.docs_per_shard

    def f(head, td_w, td_o, tw_d, tw_o, X, rs, hw):
        local = _local_h_bt_x(head[0], td_w[0], td_o[0], X, rs, hw, V, dps)
        part = _local_h_b_y_partial(head[0], tw_d[0], tw_o[0], local,
                                    rs, hw, V)
        return jax.lax.psum(part, AXIS)

    return _sm(
        ("h_gram_x", V, dps), lambda: f, mesh,
        (P(AXIS),) * 5 + (P(), P(), P()), P(),
    )(h.head, h.td_word, h.td_odoc, h.tw_doc, h.tw_oword, X,
      h.row_scale, h.head_words)
