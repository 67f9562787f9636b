"""Out-of-core training ON THE MESH: the streamed pipeline's corpus
passes doc-sharded across devices (SURVEY.md §5.7 x §5.8 composed).

This is the mesh analog of the reference's two scale mechanisms —
nnz-balanced chunking (include/matUtils.h:244-268) and word-chunked
streaming (src/trainer.cpp:438-469) — running on a jax.sharding.Mesh:

  - the device-RESIDENT compact corpus (streaming.ResidentLoader) splits
    into per-device slabs along contiguous doc ranges; every device
    decodes its own chunks (S-way parallel passes, each shard's slab is
    S-fold smaller than single-device residency);
  - additive accumulators follow the in-core sharded plan: the threshold
    histogram and the model SpMM psum over the mesh; doc weights, doc-topic
    mass and per-doc W stay doc-sharded with zero communication;
  - B assembles per shard directly into sharding.ShardedDocSparse, so the
    whole middle (global-head hybrid layout, psum'd Gram eigensolver,
    projected k-means, sharded full-space Lloyd's) REUSES the in-core
    sharded machinery verbatim;
  - the per-topic model rank threshold (topic_model.model_thresholds'
    rank_threshold-th largest doc mass) is computed EXACTLY without
    gathering the (D, k) mass to one device: a bitwise binary search over
    the float32 ordering with psum'd counts (31 fixed iterations) — the
    doc-sharded mass never leaves its shard.

Per-shard flat mass indexing also lifts the single-device limit
(streaming.streamed_topic_model asserts (D+1)*k < 2^31; here the bound is
per shard, S times looser).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .corpus import Corpus
from .sharding import AXIS, ShardedDocSparse, _pvary, _sm
from .thresholds import freq_bound, _zeta_from_hist


def _put(mesh: Mesh, x: np.ndarray):
    return jax.device_put(x, NamedSharding(mesh, P(AXIS)))


def _flat_doc_index(D: int, S: int, dps: int) -> np.ndarray:
    """Flat (shard*dps + local) positions of docs 0..D-1 (the even
    contiguous split shard_doc_sparse uses)."""
    valid = np.clip(D - np.arange(S) * dps, 0, dps)
    return np.concatenate(
        [s * dps + np.arange(v, dtype=np.int64) for s, v in enumerate(valid)]
    ).astype(np.int32) if S else np.zeros((0,), np.int32)


def _padded_row_index(D: int, S: int, dps: int) -> np.ndarray:
    """Positions of docs 0..D-1 inside the flattened (S, dps + 1)
    doc-sharded accumulators (row dps of each shard is the spill/pad
    row). The single source for this mapping — it must agree with the
    shard split everywhere it is used."""
    flat = _flat_doc_index(D, S, dps)
    return (flat // dps) * (dps + 1) + (flat % dps)


@dataclasses.dataclass
class ShardedResidentLoader:
    """Doc-sharded device-resident compact corpus.

    Each device holds the slab for its contiguous doc range (dps =
    ceil(D/S) docs, matching sharding.shard_doc_sparse so doc-sharded
    accumulators compose with compact_doc_rows/pad_doc_rows):

      w_res  (S, slab)       int32 word ids (pad vocab)
      cv_res (S, slab)       counts (smallest int dtype) or f32 vals
      off    (S, dps+mdoc+2) int32 LOCAL entry offsets per doc
      ds     (S, dps+1)      f32 doc sums (pad 1.0)

    Chunk grid: per shard, doc-aligned windows of <= chunk_entries,
    padded to a common max_chunks with empty chunks, so one shard_map
    program serves every (pass, chunk) pair. step functions receive the
    chunk INDEX as a traced operand.

    Values rebuild as avg * (count / doc_sum) in f32 — the same
    expression, in the same order, as Corpus.from_entries and every other
    loader (counts form); corpora with unusable raw counts store f32
    values verbatim (vals form)."""

    corpus: Corpus
    chunk: int
    mesh: Mesh

    def __post_init__(self):
        corpus, chunk, mesh = self.corpus, self.chunk, self.mesh
        S = mesh.devices.size
        D, V = corpus.num_docs, corpus.vocab_size
        dps = -(-D // S) if D else 1
        self.S, self.dps, self.D, self.V = S, dps, D, V

        # counts form when raw integral counts reproduce vals exactly
        # (same decision as streaming._compact_plan's rebuild check).
        avg = np.float32(corpus.avg_doc_sz)
        counts_form = (
            corpus.counts is not None
            and corpus.nnz > 0
            and bool(np.all(corpus.counts == np.floor(corpus.counts)))
            and corpus.vals_match(
                lambda c, ds: avg * (c.astype(np.float32) / ds)
            )
        )
        self.counts_form = counts_form
        self.avg = avg if counts_form else np.float32(0.0)
        cmax = float(corpus.counts.max()) if (
            counts_form and corpus.nnz) else 0.0
        cdtype = (np.uint8 if cmax < 256 else
                  np.uint16 if cmax < 65536 else np.int32)

        # per-shard doc ranges and chunk grids
        offsets = corpus.offsets
        max_doc = int(np.diff(offsets).max()) if D else 0
        if max_doc > chunk:
            # Same contract as streaming.doc_chunks: chunk windows are
            # doc-aligned, so a doc larger than one window cannot be
            # represented — without this guard the grid clamps hi to
            # lo+1 but decode_local slices only `chunk` entries and the
            # doc's tail is SILENTLY dropped from every pass.
            raise ValueError(
                f"chunk_entries={chunk} smaller than the largest doc "
                f"({max_doc} nnz)"
            )
        bounds_d = [min(s * dps, D) for s in range(S + 1)]
        chunks_per_shard = []
        max_docs = 1
        for s in range(S):
            lo_d, hi_d = bounds_d[s], bounds_d[s + 1]
            cs = []
            lo = lo_d
            while lo < hi_d:
                hi = int(np.searchsorted(
                    offsets, offsets[lo] + chunk, side="right") - 1)
                hi = max(min(hi, hi_d), lo + 1)
                cs.append((lo - lo_d, hi - lo_d))
                max_docs = max(max_docs, hi - lo)
                lo = hi
            chunks_per_shard.append(cs)
        self.max_chunks = max(
            (len(c) for c in chunks_per_shard), default=1) or 1
        self.mdoc = max_docs + 1

        n_per = np.array([
            int(offsets[bounds_d[s + 1]] - offsets[bounds_d[s]])
            for s in range(S)
        ], np.int64)
        slab = int(max(n_per.max(initial=0) + chunk, chunk))
        self.slab = slab
        self.slab_bytes_per_shard = slab * (
            4 + (np.dtype(cdtype).itemsize if counts_form else 4)
        ) + 4 * (dps + self.mdoc + 2) + 4 * (dps + 1)

        w_h = np.full((S, slab), V, np.int32)
        cv_h = (np.zeros((S, slab), cdtype) if counts_form
                else np.zeros((S, slab), np.float32))
        off_h = np.zeros((S, dps + self.mdoc + 2), np.int32)
        ds_h = np.ones((S, dps + 1), np.float32)
        a_tab = np.zeros((S, self.max_chunks), np.int32)
        lo_tab = np.zeros((S, self.max_chunks), np.int32)
        cnt_tab = np.zeros((S, self.max_chunks), np.int32)
        doc_sums = corpus.doc_sums()
        for s in range(S):
            lo_d, hi_d = bounds_d[s], bounds_d[s + 1]
            a0 = int(offsets[lo_d])
            n = int(offsets[hi_d]) - a0
            w_h[s, :n] = corpus.rows[a0:a0 + n].astype(np.int32)
            if counts_form:
                cv_h[s, :n] = corpus.counts[a0:a0 + n].astype(cdtype)
            else:
                cv_h[s, :n] = corpus.vals[a0:a0 + n]
            loc = (offsets[lo_d:hi_d + 1] - a0).astype(np.int32)
            off_h[s, :] = n  # pad boundary markers at the slab end
            off_h[s, : hi_d - lo_d + 1] = loc
            ds_h[s, : hi_d - lo_d] = doc_sums[lo_d:hi_d]
            for i, (clo, chi) in enumerate(chunks_per_shard[s]):
                a_tab[s, i] = loc[clo]
                lo_tab[s, i] = clo
                cnt_tab[s, i] = loc[chi] - loc[clo]
            # empty pad chunks: cnt 0, window at the valid end
            for i in range(len(chunks_per_shard[s]), self.max_chunks):
                lo_tab[s, i] = hi_d - lo_d

        # host-staged copies kept for release()/refill (the compact
        # corpus is ~5 B/entry of host RAM; a refill is then just the
        # device_put, no re-encode)
        self._host = (w_h, cv_h, off_h, ds_h, a_tab, lo_tab, cnt_tab)
        self.fill_count = 0
        self._fill()

    def _fill(self):
        self.fill_count += 1
        mesh = self.mesh
        (w_h, cv_h, off_h, ds_h, a_tab, lo_tab, cnt_tab) = self._host
        self.w_res = _put(mesh, w_h)
        self.cv_res = _put(mesh, cv_h)
        self.off = _put(mesh, off_h)
        self.ds = _put(mesh, ds_h)
        self.a_tab = _put(mesh, a_tab)
        self.lo_tab = _put(mesh, lo_tab)
        self.cnt_tab = _put(mesh, cnt_tab)

    def release(self):
        """Free the device slabs (HBM pressure valve for the middle
        stages); arrays() transparently refills from the host staging."""
        self.w_res = self.cv_res = self.off = self.ds = None
        self.a_tab = self.lo_tab = self.cnt_tab = None

    # ------------------------------------------------------------------
    def arrays(self):
        """The 7 sharded operands every per-chunk step threads through."""
        if self.w_res is None:
            self._fill()
        return (self.w_res, self.cv_res, self.off, self.ds,
                self.a_tab, self.lo_tab, self.cnt_tab)

    def in_specs(self):
        return (P(AXIS),) * 7

    def decode_local(self, w_res, cv_res, off, ds, a_tab, lo_tab, cnt_tab,
                     i):
        """Shard-local decode of chunk i: (w, v, d_local) with pads
        (V, 0.0, dps). Call INSIDE shard_map on the [0]-indexed blocks."""
        V, dps, chunk, mdoc = self.V, self.dps, self.chunk, self.mdoc
        a = a_tab[i]
        lo = lo_tab[i]
        cnt = cnt_tab[i]
        w = jax.lax.dynamic_slice(w_res, (a,), (chunk,))
        cv = jax.lax.dynamic_slice(cv_res, (a,), (chunk,))
        loff = jax.lax.dynamic_slice(off, (lo,), (mdoc,)) - a
        marks = jnp.zeros((chunk,), jnp.int32).at[loff[1:]].add(
            1, mode="drop")
        dl = jnp.cumsum(marks)
        in_range = jnp.arange(chunk, dtype=jnp.int32) < cnt
        d = jnp.where(in_range, jnp.minimum(lo + dl, dps), dps)
        w = jnp.where(in_range, w, V)
        if self.counts_form:
            v = jnp.where(w < V, self.avg * (cv.astype(jnp.float32) / ds[d]),
                          0.0)
        else:
            v = jnp.where(in_range, cv, 0.0)
        return w, v, d


# ---------------------------------------------------------------------------
# Stage 1: thresholds — per-shard banked histogram, one final psum.
# ---------------------------------------------------------------------------


def sharded_streamed_thresholds(
    loader: ShardedResidentLoader, num_topics: int, hyper,
) -> Tuple[np.ndarray, int]:
    corpus, mesh = loader.corpus, loader.mesh
    V = corpus.vocab_size
    F = freq_bound(corpus.avg_doc_sz)
    nbanks = (F + 1 + 127) // 128

    def f(hist, *args):
        w, v, _ = loader.decode_local(*(x[0] for x in args[:-1]), args[-1])
        r = jnp.clip(jnp.floor(v + 0.5).astype(jnp.int32), 0, F)
        n = w.shape[0]
        sub = max(min(1 << 20, n), 1)
        while n % sub:
            sub //= 2

        def body(acc, sc):
            wi, ri = sc
            row = wi * nbanks + ri // 128
            # int32 bins (see thresholds._hist_banked: f32 saturates at
            # 2^24)
            return acc.at[row].add(
                jax.nn.one_hot(ri % 128, 128, dtype=jnp.int32)), None

        out, _ = jax.lax.scan(
            body, hist[0], (w.reshape(-1, sub), r.reshape(-1, sub)))
        return out[None]

    step = jax.jit(lambda hist, arrs, i: jax.shard_map(
        f, mesh=mesh,
        in_specs=(P(AXIS),) + loader.in_specs() + (P(),),
        out_specs=P(AXIS),
    )(hist, *arrs, i), donate_argnums=(0,))

    hist = _put(mesh, np.zeros(
        (loader.S, (V + 1) * nbanks, 128), np.int32))
    for i in range(loader.max_chunks):
        hist = step(hist, loader.arrays(), jnp.int32(i))

    def reduce_f(hist):
        return jax.lax.psum(hist[0], AXIS)

    h = _sm(("ss_hist_reduce",), lambda: reduce_f, mesh, (P(AXIS),),
            P())(hist)
    h = h.reshape(V + 1, nbanks * 128)[:V, : F + 1].astype(jnp.int32)
    h = h.at[:, 0].set(0)
    zeta, nnz_w = _zeta_from_hist(
        h,
        hyper.count_gr(corpus.nz_docs, num_topics),
        hyper.count_eq(corpus.nz_docs, num_topics),
        jnp,
        few_drop=hyper.few_samples_threshold_drop,
        bad_drop=hyper.bad_threshold_drop,
    )
    return np.asarray(zeta, np.float32), int(nnz_w.sum())


# ---------------------------------------------------------------------------
# Stage 2: per-doc importance weights — doc-sharded, zero communication.
# ---------------------------------------------------------------------------


def sharded_streamed_doc_weights(
    loader: ShardedResidentLoader, zetas: np.ndarray,
) -> jax.Array:
    """(D,) global doc weights (sum of passing zetas,
    src/sparseMatrix.cpp:1383-1397), gathered from the doc-sharded
    accumulators (tiny: 4 B/doc)."""
    mesh, dps, V = loader.mesh, loader.dps, loader.V
    z = jnp.asarray(zetas, jnp.float32)

    def f(acc, z, *args):
        w, v, d = loader.decode_local(*(x[0] for x in args[:-1]), args[-1])
        zline = jnp.concatenate([z, jnp.full((1,), jnp.inf, jnp.float32)])
        zw = jnp.concatenate([z, jnp.zeros((1,), jnp.float32)])
        keep = jnp.floor(v + 0.5) >= zline[w]
        return acc[0].at[d].add(jnp.where(keep, zw[w], 0.0))[None]

    step = jax.jit(lambda acc, z, arrs, i: jax.shard_map(
        f, mesh=mesh,
        in_specs=(P(AXIS), P()) + loader.in_specs() + (P(),),
        out_specs=P(AXIS),
    )(acc, z, *arrs, i), donate_argnums=(0,))

    acc = _put(mesh, np.zeros((loader.S, dps + 1), np.float32))
    for i in range(loader.max_chunks):
        acc = step(acc, z, loader.arrays(), jnp.int32(i))
    pick = jnp.asarray(_padded_row_index(loader.D, loader.S, dps))
    return jnp.take(
        jnp.asarray(acc).reshape(loader.S * (dps + 1)),
        pick,
    )


# ---------------------------------------------------------------------------
# Stage 3: B construction — per-shard streamed compaction into a
# ShardedDocSparse (the in-core sharded middle consumes it unchanged).
# ---------------------------------------------------------------------------


def sharded_streamed_build_b(
    loader: ShardedResidentLoader,
    zetas: np.ndarray,
    select_docs: Optional[np.ndarray],
    pad_multiple: int = 1 << 13,
) -> Tuple[ShardedDocSparse, np.ndarray]:
    mesh, S, dps, V, D = (loader.mesh, loader.S, loader.dps, loader.V,
                          loader.D)
    z = jnp.asarray(zetas, jnp.float32)
    if select_docs is not None:
        sel_h = np.zeros((S, dps + 1), bool)
        sel_h.reshape(-1)[_padded_row_index(D, S, dps)] = (
            np.asarray(select_docs))
    else:
        sel_h = np.ones((S, dps + 1), bool)
    sel = _put(mesh, sel_h)

    # Phase 1: per-shard occupancy + kept counts, streamed.
    def occ_f(occ, kept, z, sel, *args):
        w, v, d = loader.decode_local(*(x[0] for x in args[:-1]), args[-1])
        zline = jnp.concatenate([z, jnp.full((1,), jnp.inf, jnp.float32)])
        keep = (jnp.floor(v + 0.5) >= zline[w]) & sel[0][d]
        occ2 = occ[0].at[d].add(keep.astype(jnp.int32))
        kept2 = kept[0] + jnp.sum(keep.astype(jnp.int32))[None]
        return occ2[None], kept2[None]

    occ_step = jax.jit(lambda occ, kept, z, sel, arrs, i: jax.shard_map(
        occ_f, mesh=mesh,
        in_specs=(P(AXIS), P(AXIS), P(), P(AXIS)) + loader.in_specs()
        + (P(),),
        out_specs=(P(AXIS), P(AXIS)),
    )(occ, kept, z, sel, *arrs, i), donate_argnums=(0, 1))

    occ = _put(mesh, np.zeros((S, dps + 1), np.int32))
    kept = _put(mesh, np.zeros((S, 1), np.int32))
    for i in range(loader.max_chunks):
        occ, kept = occ_step(occ, kept, z, sel, loader.arrays(),
                             jnp.int32(i))
    occ_h = np.asarray(occ)[:, :dps] > 0
    kept_h = np.asarray(kept)[:, 0]
    valid_A = np.clip(D - np.arange(S) * dps, 0, dps)
    for s in range(S):
        occ_h[s, valid_A[s]:] = False
    nzd = occ_h.sum(axis=1).astype(np.int64)
    original_cols = np.concatenate(
        [s * dps + np.flatnonzero(occ_h[s]) for s in range(S)]
    ).astype(np.int32) if S else np.zeros((0,), np.int32)

    dps_B = int(max(((int(nzd.max(initial=0)) + 7) // 8) * 8, 8))
    n_pad_B = int(max(
        pad_multiple,
        -(-int(kept_h.max(initial=0)) // pad_multiple) * pad_multiple,
    ))
    renum = np.full((S, dps + 1), dps_B, np.int32)
    for s in range(S):
        renum[s, :dps][occ_h[s]] = np.arange(nzd[s], dtype=np.int32)
    renum_d = _put(mesh, renum)

    # Phase 2: streamed stable compaction (chunks arrive in doc order, so
    # the per-shard output is doc-sorted like sharded_threshold_and_copy).
    sqz = np.sqrt(np.asarray(zetas, np.float32))
    sqz_d = jnp.asarray(np.concatenate([sqz, [0.0]]).astype(np.float32))

    def cmp_f(ow, od, ov, cur, z, sqzp, sel, renum, *args):
        w, v, d = loader.decode_local(*(x[0] for x in args[:-1]), args[-1])
        zline = jnp.concatenate([z, jnp.full((1,), jnp.inf, jnp.float32)])
        keep = (jnp.floor(v + 0.5) >= zline[w]) & sel[0][d]
        pos = jnp.where(keep, cur[0][0] + jnp.cumsum(
            keep.astype(jnp.int32)) - 1, n_pad_B)
        ow2 = ow[0].at[pos].set(w, mode="drop")
        od2 = od[0].at[pos].set(renum[0][d], mode="drop")
        ov2 = ov[0].at[pos].set(sqzp[w], mode="drop")
        cur2 = cur[0] + jnp.sum(keep.astype(jnp.int32))[None]
        return ow2[None], od2[None], ov2[None], cur2[None]

    cmp_step = jax.jit(
        lambda ow, od, ov, cur, z, sqzp, sel, renum, arrs, i: jax.shard_map(
            cmp_f, mesh=mesh,
            in_specs=(P(AXIS),) * 4 + (P(), P(), P(AXIS), P(AXIS))
            + loader.in_specs() + (P(),),
            out_specs=(P(AXIS),) * 4,
        )(ow, od, ov, cur, z, sqzp, sel, renum, *arrs, i),
        donate_argnums=(0, 1, 2, 3),
    )

    ow = _put(mesh, np.full((S, n_pad_B), V, np.int32))
    od = _put(mesh, np.full((S, n_pad_B), dps_B, np.int32))
    ov = _put(mesh, np.zeros((S, n_pad_B), np.float32))
    cur = _put(mesh, np.zeros((S, 1), np.int32))
    for i in range(loader.max_chunks):
        ow, od, ov, cur = cmp_step(ow, od, ov, cur, z, sqz_d, sel, renum_d,
                                   loader.arrays(), jnp.int32(i))

    # Word-sorted copy: one per-shard device sort (cheap; see CLAUDE.md).
    def sort_f(ow, od, ov):
        ww, wd, wv = jax.lax.sort((ow[0], od[0], ov[0]), num_keys=2)
        return ww[None], wd[None], wv[None]

    ww, wd, wv = _sm(
        ("ss_sort3",), lambda: sort_f, mesh, (P(AXIS),) * 3,
        (P(AXIS),) * 3,
    )(ow, od, ov)

    prefix = np.concatenate([[0], np.cumsum(nzd)[:-1]]).astype(np.int32)
    B = ShardedDocSparse(
        d_word=ow, d_doc=od, d_val=ov,
        w_word=ww, w_doc=wd, w_val=wv,
        doc_offset=_put(mesh, prefix[:, None]),
        vocab=V, docs_per_shard=dps_B, num_docs=int(nzd.sum()),
        nnz=int(kept_h.sum()), valid_docs=tuple(int(x) for x in nzd),
    )
    return B, original_cols


# ---------------------------------------------------------------------------
# Stage 4 input: filter to clustered docs (global ids), host-assembled for
# the word-sharded r-th-highest kernel.
# ---------------------------------------------------------------------------


def sharded_streamed_filter_clustered(
    loader: ShardedResidentLoader, cluster_of_doc: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-shard streamed compaction of the clustered sub-matrix (the
    sampled ~10% of A), pulled to host as (words, docs_global, vals) for
    sharding.shard_by_word + sharded_rth_highest. The pull moves the
    FILTERED data only — the same volume the single-device streamed path
    materializes on one chip, here assembled from S shards."""
    mesh, S, dps, V, D = (loader.mesh, loader.S, loader.dps, loader.V,
                          loader.D)
    cl_h = np.zeros((S, dps + 1), np.int32) - 1
    cl_h.reshape(-1)[_padded_row_index(D, S, dps)] = (
        cluster_of_doc.astype(np.int32))
    cl = _put(mesh, cl_h)

    # Phase 1: kept counts.
    def cnt_f(kept, cl, *args):
        w, v, d = loader.decode_local(*(x[0] for x in args[:-1]), args[-1])
        keep = (cl[0][d] >= 0) & (w < V)
        return (kept[0] + jnp.sum(keep.astype(jnp.int32))[None])[None]

    cnt_step = jax.jit(lambda kept, cl, arrs, i: jax.shard_map(
        cnt_f, mesh=mesh,
        in_specs=(P(AXIS), P(AXIS)) + loader.in_specs() + (P(),),
        out_specs=P(AXIS),
    )(kept, cl, *arrs, i), donate_argnums=(0,))

    kept = _put(mesh, np.zeros((S, 1), np.int32))
    for i in range(loader.max_chunks):
        kept = cnt_step(kept, cl, loader.arrays(), jnp.int32(i))
    kept_h = np.asarray(kept)[:, 0]
    n_pad = int(max(1 << 13, -(-int(kept_h.max(initial=0)) // 8192) * 8192))

    base = np.arange(S, dtype=np.int32)[:, None] * dps
    base_d = _put(mesh, base)

    def flt_f(ow, od, ov, cur, cl, base, *args):
        w, v, d = loader.decode_local(*(x[0] for x in args[:-1]), args[-1])
        keep = (cl[0][d] >= 0) & (w < V)
        pos = jnp.where(keep, cur[0][0] + jnp.cumsum(
            keep.astype(jnp.int32)) - 1, n_pad)
        d_glob = jnp.where(d < dps, base[0][0] + d, D)
        ow2 = ow[0].at[pos].set(w, mode="drop")
        od2 = od[0].at[pos].set(d_glob, mode="drop")
        ov2 = ov[0].at[pos].set(v, mode="drop")
        cur2 = cur[0] + jnp.sum(keep.astype(jnp.int32))[None]
        return ow2[None], od2[None], ov2[None], cur2[None]

    flt_step = jax.jit(lambda ow, od, ov, cur, cl, base, arrs, i: jax.shard_map(
        flt_f, mesh=mesh,
        in_specs=(P(AXIS),) * 4 + (P(AXIS), P(AXIS)) + loader.in_specs()
        + (P(),),
        out_specs=(P(AXIS),) * 4,
    )(ow, od, ov, cur, cl, base, *arrs, i), donate_argnums=(0, 1, 2, 3))

    ow = _put(mesh, np.full((S, n_pad), V, np.int32))
    od = _put(mesh, np.full((S, n_pad), D, np.int32))
    ov = _put(mesh, np.zeros((S, n_pad), np.float32))
    cur = _put(mesh, np.zeros((S, 1), np.int32))
    for i in range(loader.max_chunks):
        ow, od, ov, cur = flt_step(ow, od, ov, cur, cl, base_d,
                                   loader.arrays(), jnp.int32(i))
    ow_h, od_h, ov_h = np.asarray(ow), np.asarray(od), np.asarray(ov)
    ws, ds_, vs = [], [], []
    for s in range(S):
        n = int(kept_h[s])
        ws.append(ow_h[s, :n])
        ds_.append(od_h[s, :n])
        vs.append(ov_h[s, :n])
    return (np.concatenate(ws) if S else np.zeros(0, np.int32),
            np.concatenate(ds_) if S else np.zeros(0, np.int32),
            np.concatenate(vs) if S else np.zeros(0, np.float32))


# ---------------------------------------------------------------------------
# Stages 5-6: doc-topic mass (doc-sharded) + model accumulation (psum).
# ---------------------------------------------------------------------------


def sharded_streamed_mass(
    loader: ShardedResidentLoader, cw_topic: np.ndarray, k: int,
) -> jax.Array:
    """(S, dps+1, k) doc-sharded catchword-topic mass; the spill row dps
    absorbs non-catchword and padded entries (all-zero, see
    streaming.streamed_topic_model's spill-row note)."""
    mesh, S, dps = loader.mesh, loader.S, loader.dps
    assert (dps + 1) * k < (1 << 31), (
        "per-shard flat mass index exceeds int32; add more devices"
    )
    cwt = jnp.asarray(
        np.concatenate([cw_topic.astype(np.int32), [-1]]))

    def f(mass, cwt, *args):
        w, v, d = loader.decode_local(*(x[0] for x in args[:-1]), args[-1])
        t = cwt[w]
        is_cw = t >= 0
        dd = jnp.where(is_cw, d, dps)
        tt = jnp.maximum(t, 0)
        return mass[0].at[dd * jnp.int32(k) + tt].add(
            jnp.where(is_cw, v, 0.0))[None]

    step = jax.jit(lambda mass, cwt, arrs, i: jax.shard_map(
        f, mesh=mesh,
        in_specs=(P(AXIS), P()) + loader.in_specs() + (P(),),
        out_specs=P(AXIS),
    )(mass, cwt, *arrs, i), donate_argnums=(0,))

    mass = _put(mesh, np.zeros((S, (dps + 1) * k), np.float32))
    for i in range(loader.max_chunks):
        mass = step(mass, cwt, loader.arrays(), jnp.int32(i))
    return mass.reshape(S, dps + 1, k)


def sharded_model_thresholds(
    mass: jax.Array, has_catchwords: jax.Array, rank_threshold: int,
    num_docs: int, mesh: Mesh,
) -> jax.Array:
    """Per-topic rank_threshold-th largest doc mass WITHOUT gathering the
    doc-sharded (S, dps+1, k) mass: a bitwise binary search over the
    nonnegative-float32 ordering (int32 bit patterns order identically)
    with one psum'd count per iteration — 31 fixed iterations, exact.

    Matches topic_model.model_thresholds: the r-th largest equals the
    largest value v with count(mass >= v) >= r; topics with fewer than
    rank_threshold positive masses (or no catchwords) get 0. The spill
    row dps and invalid doc slots hold exact zeros, so they never affect
    counts for v > 0 and the gates zero every v == 0 outcome."""
    S, dps1, k = mass.shape
    if rank_threshold <= 0 or rank_threshold > num_docs:
        return jnp.zeros((k,), jnp.float32)

    def f(mass, has_cw):
        m = mass[0]  # (dps+1, k) local
        pos_counts = jax.lax.psum(
            jnp.sum((m > 0.0).astype(jnp.int32), axis=0), AXIS)

        def count_ge(v_bits):
            v = jax.lax.bitcast_convert_type(v_bits, jnp.float32)
            c = jnp.sum((m >= v[None, :]).astype(jnp.int32), axis=0)
            return jax.lax.psum(c, AXIS)

        def body(_, state):
            lo, hi = state  # invariant: count_ge(lo) >= r > count_ge(hi)
            mid = lo + (hi - lo) // 2  # (lo+hi)//2 overflows int32
            ok = count_ge(mid) >= rank_threshold
            return jnp.where(ok, mid, lo), jnp.where(ok, hi, mid)

        lo0 = jnp.zeros((k,), jnp.int32)
        hi0 = jnp.full((k,), np.int32(0x7f800000))  # +inf: count 0 < r
        lo, _ = jax.lax.fori_loop(0, 31, body, (lo0, hi0))
        thr = jax.lax.bitcast_convert_type(lo, jnp.float32)
        thr = jnp.where(pos_counts >= rank_threshold, thr, 0.0)
        return jnp.where(has_cw, thr, 0.0)

    return _sm(
        ("ss_model_thr", rank_threshold), lambda: f, mesh,
        (P(AXIS), P()), P(),
    )(mass, has_catchwords)


def sharded_streamed_model(
    loader: ShardedResidentLoader, W: jax.Array, k: int,
) -> jax.Array:
    """(V, k) replicated model: per-shard partial accumulation over the
    shard's chunks, one psum at the end. W: (S, dps+1, k) doc-sharded
    contribution weights (row dps zero)."""
    mesh, S, V = loader.mesh, loader.S, loader.V

    def f(model, W, *args):
        w, v, d = loader.decode_local(*(x[0] for x in args[:-1]), args[-1])
        n = w.shape[0]
        sub = max(min(1 << 21, n), 1)
        while n % sub:
            sub //= 2

        def body(m, sc):
            w_, v_, d_ = sc
            rows = jnp.take(W[0], d_, axis=0) * v_[:, None]
            return m.at[w_].add(rows), None

        out, _ = jax.lax.scan(
            body, model[0],
            (w.reshape(-1, sub), v.reshape(-1, sub), d.reshape(-1, sub)))
        return out[None]

    step = jax.jit(lambda model, W, arrs, i: jax.shard_map(
        f, mesh=mesh,
        in_specs=(P(AXIS), P(AXIS)) + loader.in_specs() + (P(),),
        out_specs=P(AXIS),
    )(model, W, *arrs, i), donate_argnums=(0,))

    model = _put(mesh, np.zeros((S, V + 1, k), np.float32))
    for i in range(loader.max_chunks):
        model = step(model, W, loader.arrays(), jnp.int32(i))

    def reduce_f(model):
        return jax.lax.psum(model[0], AXIS)

    m = _sm(("ss_model_reduce",), lambda: reduce_f, mesh, (P(AXIS),),
            P())(model)[:V]
    sums = jnp.sum(m, axis=0)
    return jnp.where(sums[None, :] != 0.0, m / sums[None, :], m)


def sharded_top_two_topics(mass: jax.Array, loader: ShardedResidentLoader):
    """Per-doc top-2 topics from the doc-sharded mass; returns GLOBAL
    (D,) host-order arrays (tiny int/bool payloads)."""
    mesh, S, dps, D = loader.mesh, loader.S, loader.dps, loader.D
    k = mass.shape[-1]

    def f(mass):
        m = mass[0]  # (dps+1, k)
        v1 = jnp.max(m, axis=1)
        t1 = jnp.argmax(m, axis=1)
        cols = jnp.arange(k, dtype=t1.dtype)[None, :]
        masked = jnp.where(cols == t1[:, None], -jnp.inf, m)
        v2 = jnp.max(masked, axis=1)
        t2 = jnp.argmax(masked, axis=1)
        valid = (v1 > 0.0) & (v2 > 0.0)
        return (t1.astype(jnp.int32)[None], t2.astype(jnp.int32)[None],
                valid[None])

    t1, t2, valid = _sm(
        ("ss_top2", k), lambda: f, mesh, (P(AXIS),), (P(AXIS),) * 3,
    )(mass)
    pick = _padded_row_index(D, S, dps)
    return (np.asarray(t1).reshape(-1)[pick],
            np.asarray(t2).reshape(-1)[pick],
            np.asarray(valid).reshape(-1)[pick])


def sharded_contribution_weights(
    mass: jax.Array, thr: jax.Array, cluster_of_doc: np.ndarray,
    loader: ShardedResidentLoader,
) -> jax.Array:
    """(S, dps+1, k) doc-sharded W (topic_model._contribution_weights on
    the mesh; mass is donated shard-locally)."""
    mesh, S, dps, D = loader.mesh, loader.S, loader.dps, loader.D
    k = mass.shape[-1]
    cl_h = np.zeros((S, dps + 1), np.int32) - 1
    cl_h.reshape(-1)[_padded_row_index(D, S, dps)] = (
        cluster_of_doc.astype(np.int32))
    cl = _put(mesh, cl_h)

    def f(mass, cl, thr):
        m = mass[0]
        W = (m > thr[None, :]).astype(jnp.float32)
        c = cl[0]
        W = W + jax.nn.one_hot(jnp.where(c >= 0, c, k), k,
                               dtype=jnp.float32)
        return W[None]

    return jax.jit(lambda mass, cl, thr: jax.shard_map(
        f, mesh=mesh, in_specs=(P(AXIS), P(AXIS), P()),
        out_specs=P(AXIS),
    )(mass, cl, thr), donate_argnums=(0,))(mass, cl, thr)


# ---------------------------------------------------------------------------
# Orchestration: the StreamedTrainer mesh path.
# ---------------------------------------------------------------------------


def train_sharded_streamed(st, resume: bool = False) -> None:
    """StreamedTrainer.train() body for cfg.device.mesh_shape != ():
    streamed corpus passes doc-sharded over the mesh, middle and finish
    reusing the in-core sharded machinery (trainer._train_sharded's
    stages on the streamed-built ShardedDocSparse)."""
    from .kmeans import kmeans_init_on_projected, run_lloyds_projected
    from .sharding import (
        compact_doc_rows,
        make_mesh,
        shard_hybrid,
        sharded_gram_x,
        sharded_bt_x,
        sharded_h_bt_x,
        sharded_h_gram_x,
        sharded_run_lloyds_full,
        sharded_spmm_flops,
    )
    from .trainer import solve_gram_eigens

    t = st._t
    cfg = t.config
    hp = cfg.hyper
    k = cfg.num_topics
    corpus = t.corpus
    D, V = corpus.num_docs, corpus.vocab_size
    key = jax.random.PRNGKey(cfg.seed)
    HI = jax.lax.Precision.HIGHEST

    n_dev = cfg.device.mesh_devices()
    if len(jax.devices()) < n_dev:
        raise RuntimeError(
            f"mesh_shape={cfg.device.mesh_shape} needs {n_dev} devices, "
            f"have {len(jax.devices())}"
        )
    mesh = make_mesh(n_dev)
    t.logger.info(f"sharded STREAMED training on {n_dev}-device mesh")

    ck = t._load_checkpoints() if resume else {}
    if t._restore_model_checkpoint(ck):
        return
    resume_kmeans = "kmeans" in ck
    resume_svd = "svd" in ck

    loader = ShardedResidentLoader(corpus, st.chunk_entries, mesh)
    st._loader = loader
    if loader.slab_bytes_per_shard > cfg.device.resident_corpus_bytes:
        raise NotImplementedError(
            f"per-shard resident slab "
            f"({loader.slab_bytes_per_shard >> 20} MiB) exceeds "
            f"device.resident_corpus_bytes; the sharded streamed mode keeps "
            f"the compact corpus device-resident (S-fold smaller per "
            f"shard) — add devices or raise the budget"
        )
    t.timer.next("sharded resident corpus fill")

    if resume_svd:
        zetas = np.asarray(ck["svd"]["zetas"])
        original_cols = ck["svd"]["original_cols"]
        t.original_cols = original_cols
        t.logger.info("resumed thresholds from 'svd' checkpoint")
    else:
        zetas, new_nnz = sharded_streamed_thresholds(loader, k, hp)
        t.logger.info(f"Entries above threshold: {new_nnz}")
        t.timer.next("streamed thresholds (sharded)")

    if resume_kmeans:
        t.centers = ck["kmeans"]["centers"]
        cluster_of_doc = ck["kmeans"]["cluster_of_doc"]
        t.cluster_of_doc = cluster_of_doc
        if resume_svd:
            t.evalues = ck["svd"]["evalues"]
        assign_h = cluster_of_doc[cluster_of_doc >= 0]
        sizes = np.bincount(assign_h, minlength=k).astype(np.int32)
        t.logger.info("resumed clustering from 'kmeans' checkpoint")
        _finish_sharded_streamed(st, loader, cluster_of_doc, sizes, k, D,
                                 hp, cfg, mesh)
        return

    select = None
    if cfg.sample_docs:
        if resume_svd:
            key, _ = jax.random.split(key)
            select = np.zeros((D,), bool)
            select[original_cols] = True
        else:
            # same key schedule and pivot rule as the single-device
            # streamed path (StreamedTrainer.train), so identical seeds
            # give identical samples across modes
            weights = sharded_streamed_doc_weights(loader, zetas)
            key, sub = jax.random.split(key)
            u = jax.random.uniform(sub, (D,), jnp.float32)
            dice = jnp.where(
                weights > 0.0,
                jnp.power(u, 1.0 / jnp.maximum(weights, 1e-30)),
                0.0,
            )
            pivot = jnp.sort(dice)[::-1][int(cfg.sample_rate * D)]
            select = np.asarray(dice >= pivot)
            t.timer.next("streamed doc sampling (sharded)")

    key, sub = jax.random.split(key)  # keep key schedule aligned
    B, original_cols = sharded_streamed_build_b(loader, zetas, select)
    t.original_cols = original_cols
    t.logger.info(
        f"Columns remaining after thresholding: {B.num_docs} "
        f"nnz(B): {B.nnz} per-shard docs: {B.valid_docs}"
    )
    t.timer.next("streamed B construction (sharded)")

    # Middle: identical to trainer._train_sharded, plus the single-device
    # streamed path's HBM planning (streaming.plan_middle_budget): the
    # per-shard resident slab stays held through the middle, so the dense
    # head shrinks into the per-chip leftover; RESOURCE_EXHAUSTED falls
    # back to releasing the slabs and retrying at the full head budget
    # (the finish passes transparently refill from host staging).
    from .streaming import plan_middle_budget

    key, sub_eig = jax.random.split(key)
    key, sub_seed = jax.random.split(key)
    # survives an OOM retry (see streaming.py's middle_state)
    middle_state: dict = {}
    slab_held = True
    head_bytes = cfg.device.dense_head_bytes
    # per-shard build temporaries scale with the padded per-shard tail
    per_shard_nnz = int(B.d_word.shape[1])
    keep, head_bytes = plan_middle_budget(
        cfg.device.memory_budget(), loader.slab_bytes_per_shard,
        per_shard_nnz,
        cfg.device.dense_head_bytes,
    )
    if keep:
        if head_bytes != cfg.device.dense_head_bytes:
            t.logger.info(
                f"holding per-shard resident slabs "
                f"({loader.slab_bytes_per_shard >> 20} MiB/shard) through "
                f"the middle; dense head budget {head_bytes >> 20} MiB"
            )
    else:
        loader.release()
        slab_held = False
        head_bytes = cfg.device.dense_head_bytes

    def run_middle(head_budget: int):
        B_op = B
        op_gram = lambda B_, X: sharded_gram_x(B_, X, mesh)
        op_bt_x = lambda B_, U_: sharded_bt_x(B_, U_, mesh)
        if head_budget > 0 and B.num_docs > 0:
            from .hybrid import row_scale_from_zetas

            B_op = shard_hybrid(
                B, row_scale_from_zetas(zetas), mesh, head_budget
            )
            op_gram = lambda B_, X: sharded_h_gram_x(B_, X, mesh)
            op_bt_x = lambda B_, U_: sharded_h_bt_x(B_, U_, mesh)
            t.logger.diag(
                f"sharded hybrid layout: {B_op.num_head} global head rows"
            )
            t.timer.next("hybrid layout (sharded)")

        if resume_svd:
            evalues = ck["svd"]["evalues"]
            U = jnp.asarray(ck["svd"]["U"])
            t.logger.info("resumed eigenvectors from 'svd' checkpoint")
        elif "U" in middle_state:
            evalues, U = middle_state["evalues"], middle_state["U"]
            t.logger.info("reusing eigenvectors from the pre-OOM attempt")
        else:
            evalues, U, stats = solve_gram_eigens(
                op_gram, V, k, B_op, cfg, sub_eig,
                timer=t.timer, logger=t.logger,
                start_block=t._warm_start_block(V),
            )
            if stats is not None:
                res, op_width = stats
                t.op_counter.add(
                    res.op_seconds,
                    sharded_spmm_flops(B, op_width) * res.op_calls,
                    res.op_calls,
                )
            t.timer.next("eigen solve (B B^T, sharded)")
            t._checkpoint(
                "svd", U=np.asarray(U), evalues=evalues,
                zetas=np.asarray(zetas), original_cols=original_cols,
            )
            middle_state["evalues"], middle_state["U"] = evalues, U

        P_mat = compact_doc_rows(op_bt_x(B_op, U), B).T
        seeds, centers_lowd, _ = kmeans_init_on_projected(
            P_mat, k, hp.kmeans_init_reps, sub_seed,
            method=hp.kmeans_init_method,
            mcmc_sample_size=hp.kmeansmcmc_sample_size,
        )
        centers_lowd, _ = run_lloyds_projected(
            P_mat, centers_lowd, hp.max_kmeans_lowd_reps
        )
        centers_full = jnp.matmul(centers_lowd, U.T, precision=HI)
        if hp.kmeans_algo_for_sparse == "elkans":
            from .elkans_sharded import sharded_run_elkans

            centers_full, assign_h = sharded_run_elkans(
                B_op, centers_full, hp.max_kmeans_reps, mesh, timer=t.timer
            )
        else:
            centers_full, assign_h = sharded_run_lloyds_full(
                B_op, centers_full, hp.max_kmeans_reps, mesh, timer=t.timer
            )
        return evalues, U, centers_full, assign_h

    try:
        evalues, U, centers_full, assign_h = run_middle(head_bytes)
    except Exception as e:
        oom = ("RESOURCE_EXHAUSTED" in str(e)
               or "Ran out of memory" in str(e))
        if not (slab_held and oom):
            raise
        t.logger.warning(
            "sharded middle exhausted HBM with the resident slabs held; "
            "releasing and retrying (the finish passes will refill)"
        )
        loader.release()
        slab_held = False
        evalues, U, centers_full, assign_h = run_middle(
            cfg.device.dense_head_bytes
        )
    t.evalues = evalues
    t.centers = np.asarray(centers_full)
    t.timer.next("k-means (sharded)")

    cluster_of_doc = np.full(D, -1, np.int32)
    cluster_of_doc[original_cols] = assign_h
    t.cluster_of_doc = cluster_of_doc
    sizes = np.bincount(assign_h, minlength=k).astype(np.int32)
    t._checkpoint("kmeans", centers=t.centers,
                  cluster_of_doc=cluster_of_doc)
    del B, U, centers_full
    _finish_sharded_streamed(st, loader, cluster_of_doc, sizes, k, D, hp,
                             cfg, mesh)


def _finish_sharded_streamed(st, loader, cluster_of_doc, sizes, k, D, hp,
                             cfg, mesh):
    from .catchwords import catchword_topic_map, find_catchwords
    from .sharding import shard_by_word, sharded_rth_highest

    t = st._t
    V = loader.V
    r = hp.catchword_rank(D, k, cfg.sample_rate if cfg.sample_docs else None)
    r = max(r, 1)
    fw, fd, fv = sharded_streamed_filter_clustered(loader, cluster_of_doc)
    ws_sub = shard_by_word(fw, fd, fv, V, D, mesh)
    thr = sharded_rth_highest(ws_sub, cluster_of_doc, sizes, k, r, mesh)
    t.catchword_thresholds = np.asarray(thr)
    is_cw = np.asarray(find_catchwords(jnp.asarray(thr), hp.rho))
    cwt = catchword_topic_map(is_cw)
    t.catchwords = [np.flatnonzero(is_cw[i]) for i in range(k)]
    del ws_sub, fw, fd, fv
    t.timer.next("streamed catchwords (sharded)")

    mass = sharded_streamed_mass(loader, cwt, k)
    has_cw = jnp.asarray(is_cw.any(axis=1))
    thr_m = sharded_model_thresholds(
        mass, has_cw, hp.model_rank_threshold(D, k), D, mesh
    )
    if cfg.compute_edge_topics:
        t.top_pairs = sharded_top_two_topics(mass, loader)
    W = sharded_contribution_weights(mass, thr_m, cluster_of_doc, loader)
    del mass
    model = sharded_streamed_model(loader, W, k)
    t.model = np.asarray(model)
    extra = {}
    if t.top_pairs is not None:
        extra = dict(t1=t.top_pairs[0], t2=t.top_pairs[1],
                     valid=t.top_pairs[2])
    t.timer.next("streamed topic model (sharded)")
    t._checkpoint(
        "model",
        model=t.model,
        is_cw=is_cw,
        catchword_thresholds=t.catchword_thresholds,
        **extra,
    )
    t.is_training_complete = True
