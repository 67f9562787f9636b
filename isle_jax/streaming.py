"""Out-of-core training: the corpus A stays in host RAM and streams
through the device in doc-aligned chunks; only the (much smaller)
thresholded+sampled matrix B lives on device.

This is the big-data mode for corpora whose dual-sorted nnz arrays exceed
device memory (UCI PubMed: 8.2M docs, ~730M nnz ~ 18 GB). It plays the
role of the reference's preprocessed-chunk streaming (2^24-nnz word chunks
for thresholds, src/trainer.cpp:438-469; DOC_BLOCK_SIZE streaming
everywhere) with the chunk axis being host->device transfer instead of
cache locality.

Every stage that touches A becomes an additive or filtering pass:
  1. threshold histogram       — additive (V, F) accumulation per chunk
  2. doc weights + sampling    — additive (D,) accumulation per chunk
  3. B construction            — per-chunk keep/compact appended on device
  4. r-th-highest statistics   — per-chunk filter to clustered docs (the
                                  sampled ~10%), then the in-core kernel
  5. doc-topic mass            — additive (D, k) accumulation per chunk
  6. topic-model accumulation  — additive (V, k) accumulation per chunk
Floating-point accumulation order within each doc matches the in-core
kernels (chunks are doc-aligned); cross-stage results agree to fp32
round-off, which the streamed-vs-incore equality test pins down.

The dual-sorted MATERIALIZED arrays take 24 B/entry (~18 GB at PubMed
scale), but a COMPACT resident form (word ids int32 + counts in the
smallest dtype ~ 5 B/entry = 3.9 GB) is far smaller — so by default the
corpus uploads ONCE into device-resident slabs (ResidentLoader) and every
pass decodes chunks on device, paying the host->device transfer a single
time instead of once per pass. Per-pass streaming remains the automatic
fallback for corpora beyond `device.resident_corpus_bytes`.
"""

from __future__ import annotations

from functools import partial
from typing import Iterator, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .corpus import Corpus
from .sparse import DocSparse
from .thresholds import freq_bound, _zeta_from_hist


def _drain_every(acc, i: int, every: int = 4):
    """Pace an accumulation loop: wait for the accumulator every `every`
    chunks. With the device-resident loader there is no upload to pace
    the host, so an unthrottled loop enqueues every chunk's decode ahead
    of execution — each in-flight chunk holds ~3 x chunk_entries x 4 B
    of decoded (w, v, d) output, and 24 queued chunks exhausted the
    allocator at the PubMed shape (RESOURCE_EXHAUSTED). Waiting on the
    carry bounds the queue to `every` chunks."""
    if (i + 1) % every == 0:
        jax.block_until_ready(acc)


@partial(jax.jit, static_argnames=(
    "vocab", "num_docs", "n_pad", "max_docs", "nibble"))
def _rebuild_chunk(
    d16, exc_i, exc_v, counts, cexc_i, cexc_v, local_offsets, cnt, lo,
    doc_sums, avg,
    vocab: int, num_docs: int, n_pad: int, max_docs: int, nibble: bool,
):
    """Device-side reconstruction of (w, v, d) from the compact chunk
    upload (u16 word deltas + raw counts [nibble-packed when nibble=True,
    as sparse._device_build] + per-chunk offsets): doc ids via the
    +1-marker cumsum (as sparse._device_build), word ids via the delta
    decode, and normalized values avg * (count / doc_sum) recomputed in
    f32 — the same expression, in the same order, as Corpus.from_entries.
    Pads: word=vocab, val=0, doc=num_docs."""
    from .sparse import decode_word_deltas

    pos = jnp.arange(n_pad, dtype=jnp.int32)
    marks = jnp.zeros((n_pad,), jnp.int32).at[local_offsets[1:]].add(
        1, mode="drop"
    )
    # max_docs is the local_offsets array LENGTH; its last slot pads with
    # cnt, so clamped pad entries read a doc-start of cnt (masked anyway).
    dl = jnp.minimum(jnp.cumsum(marks), max_docs - 1)
    in_range = pos < cnt
    w = decode_word_deltas(
        d16, exc_i, exc_v, None, in_range, vocab,
        doc_of_entry=dl, offsets=local_offsets,
    )
    d = jnp.where(in_range, jnp.minimum(lo + dl, num_docs), num_docs)
    if nibble:
        c_lo = (counts & 15).astype(jnp.float32)
        c_hi = (counts >> 4).astype(jnp.float32)
        c = jnp.stack([c_lo, c_hi], axis=1).reshape(n_pad)
        c = c.at[cexc_i].set(cexc_v.astype(jnp.float32), mode="drop")
    else:
        c = counts.astype(jnp.float32)
    ds = jnp.concatenate([doc_sums, jnp.ones((1,), jnp.float32)])
    v = jnp.where(w < vocab, avg * (c / ds[d]), 0.0)
    return w, v, d


def _fat_chunk_loader(corpus: Corpus, chunk_entries: int):
    """Materialized (w, v, d) per-chunk upload — the fallback when the
    compact count encoding is unusable (no raw counts, fractional counts,
    or custom normalization)."""
    D, V = corpus.num_docs, corpus.vocab_size
    n_pad = chunk_entries

    succ = {}
    prev = None
    for c in doc_chunks(corpus, chunk_entries):
        if prev is not None:
            succ[prev] = c
        prev = c
    pending = {}

    def _enc(lohi):
        lo, hi = lohi
        a, b = corpus.offsets[lo], corpus.offsets[hi]
        w = jnp.asarray(np.pad(corpus.rows[a:b].astype(np.int32),
                               (0, n_pad - (b - a)), constant_values=V))
        v = jnp.asarray(np.pad(corpus.vals[a:b], (0, n_pad - (b - a))))
        d = jnp.asarray(np.pad(
            np.repeat(np.arange(lo, hi, dtype=np.int32),
                      np.diff(corpus.offsets[lo:hi + 1]).astype(np.int64)),
            (0, n_pad - (b - a)), constant_values=D,
        ))
        return w, v, d

    def load_fat(lo, hi):
        fut = pending.pop((lo, hi), None)
        out = fut.result() if fut is not None else _enc((lo, hi))
        nxt = succ.get((lo, hi))
        pending.clear()  # at most one prefetch in flight
        if nxt is not None:
            pending[nxt] = _prefetch_ex().submit(_enc, nxt)
        return out

    return load_fat


class _CompactPlan:
    """Host-side encoding plan for the compact chunk upload (u16 word
    deltas + nibble-or-small-dtype counts + per-chunk offsets); shared by
    the per-pass loader and the device-resident fill."""

    def __init__(self, corpus: Corpus, chunk_entries: int, cdtype, nibble,
                 avg, max_docs):
        self.corpus = corpus
        self.n_pad = chunk_entries
        self.cdtype = cdtype
        self.nibble = nibble
        self.avg = avg
        self.max_docs = max_docs

    def encode_host(self, lo: int, hi: int):
        """Host half of encode(): pure numpy, no device transfer — the
        unit the pipelined resident fill runs in a worker thread while
        the previous chunk's bytes are in transfer."""
        from .sparse import _pad_exceptions, encode_word_deltas

        corpus, n_pad = self.corpus, self.n_pad
        a, b = corpus.offsets[lo], corpus.offsets[hi]
        cnt = int(b - a)
        d16, exc_i, exc_v = encode_word_deltas(corpus.rows, corpus.offsets,
                                               lo, hi)
        # floor the padded exception capacity so chunks share one jit
        # specialization (the capacity is a static shape)
        exc_i, exc_v = _pad_exceptions(exc_i, exc_v, n_pad,
                                       min_cap=1 << 16)
        craw = corpus.counts[a:b]
        if self.nibble:
            cn = np.pad(np.minimum(craw, 15).astype(np.uint8),
                        (0, n_pad - cnt))
            c = (cn[0::2] | (cn[1::2] << 4)).astype(np.uint8)
            bidx = np.flatnonzero(craw >= 15)
            cexc_i, cexc_v = _pad_exceptions(
                bidx.astype(np.int64), craw[bidx].astype(np.int32),
                n_pad, min_cap=1 << 16,
            )
        else:
            c = np.pad(craw.astype(self.cdtype), (0, n_pad - cnt))
            cexc_i, cexc_v = _pad_exceptions(
                np.zeros(0, np.int64), np.zeros(0, np.int32), n_pad
            )
        off = np.pad(
            (corpus.offsets[lo:hi + 1] - a).astype(np.int32),
            (0, self.max_docs - (hi - lo)), constant_values=cnt,
        )
        return (
            np.pad(d16, (0, n_pad - cnt)), exc_i, exc_v,
            c, cexc_i, cexc_v, off, cnt, int(a),
        )

    def encode(self, lo: int, hi: int):
        return _to_device(self.encode_host(lo, hi))


def _to_device(enc):
    """Transfer an encode_host tuple's arrays (trailing scalars ride
    through untouched)."""
    return tuple(
        jnp.asarray(x) if isinstance(x, np.ndarray) else x for x in enc
    )


def _compact_plan(corpus: Corpus, chunk_entries: int):
    """Returns a _CompactPlan, or None when the compact count encoding is
    unusable (no raw counts, fractional counts, or custom normalization —
    the caller must fall back to materialized uploads)."""
    if corpus.counts is None:
        return None
    # The compact upload casts counts to a small integer dtype; fractional
    # counts (Corpus accepts float counts) would be silently truncated, so
    # require integrality globally.
    if corpus.nnz and not bool(
        np.all(corpus.counts == np.floor(corpus.counts))
    ):
        return None

    cmax = float(corpus.counts.max()) if corpus.nnz else 0.0
    cdtype = (
        np.uint8 if cmax < 256 else np.uint16 if cmax < 65536 else np.int32
    )
    # Nibble-pack counts when counts < 15 dominate (same rule as the
    # in-core upload, sparse.from_corpus): two counts per byte halves the
    # count bytes of EVERY streamed pass (~10% of pass bytes at PubMed);
    # counts >= 15 ride a per-chunk exception list restored exactly.
    nbig = int(np.count_nonzero(corpus.counts >= 15)) if corpus.nnz else 0
    nibble = corpus.nnz > 0 and nbig < 0.02 * corpus.nnz
    avg = np.float32(corpus.avg_doc_sz)
    # The rebuild assumes the training normalization avg*(count/doc_sum)
    # with the compact dtype cast (exact int32 when nibble-packed:
    # small counts are stored verbatim, big ones via the exception list);
    # verify on a sample and fall back to shipping materialized values if
    # the corpus was normalized differently (e.g. to unit mass).
    rebuild_dtype = np.int32 if nibble else cdtype
    if corpus.nnz and not corpus.vals_match(
        lambda c, ds: avg * (c.astype(rebuild_dtype).astype(np.float32) / ds)
    ):
        return None
    # static padded per-chunk doc capacity (offsets pad with the entry
    # count, which lands the extra markers at the pad boundary)
    D = corpus.num_docs
    max_docs = 1
    lo = 0
    while lo < D:
        hi = int(np.searchsorted(
            corpus.offsets, corpus.offsets[lo] + chunk_entries, side="right"
        ) - 1)
        hi = max(min(hi, D), lo + 1)
        max_docs = max(max_docs, hi - lo)
        lo = hi
    return _CompactPlan(corpus, chunk_entries, cdtype, nibble, avg, max_docs)


def make_chunk_loader(corpus: Corpus, chunk_entries: int, plan="auto"):
    """Shared streamed-chunk loader: load(lo, hi) -> (w, v, d) device
    arrays padded to chunk_entries.

    The upload is u16 word deltas + raw counts in the smallest dtype (nibble-packed when small counts dominate) + per-chunk
    int32 offsets (~3 B/entry instead of the 12 B/entry of materialized
    w/v/d) with doc ids and normalized values rebuilt on device. Falls
    back to the fat upload when raw counts are unavailable.

    Rounding note: the compact path's value rebuild compares HOST
    arithmetic during plan validation; if the accelerator's f32 divide is
    not correctly rounded, device-rebuilt values could differ from
    `corpus.vals` by 1 ulp. That cannot break the streamed-vs-in-core
    invariant — the in-core path's compact upload (sparse._device_build)
    rebuilds values on device with the SAME expression, so both paths see
    identical numbers on any one backend — but host-side oracles compare
    exactly only on IEEE backends (the CPU test backend is)."""
    if plan == "auto":
        plan = _compact_plan(corpus, chunk_entries)
    if plan is None:
        return _fat_chunk_loader(corpus, chunk_entries)
    D, V = corpus.num_docs, corpus.vocab_size
    doc_sums = jnp.asarray(corpus.doc_sums())  # one (D,) upload, reused

    # One-ahead prefetch: every streamed stage walks doc_chunks in
    # order, so while the device consumes chunk i the successor's host
    # encode + transfer already runs on the shared worker. A stage
    # restart (next pass from chunk 0) just misses once and re-primes.
    succ = {}
    prev = None
    for c in doc_chunks(corpus, chunk_entries):
        if prev is not None:
            succ[prev] = c
        prev = c
    pending = {}

    def _enc(lohi):
        return _to_device(plan.encode_host(*lohi))

    def load(lo, hi):
        fut = pending.pop((lo, hi), None)
        enc = fut.result() if fut is not None else _enc((lo, hi))
        (d16, exc_i, exc_v, c, cexc_i, cexc_v, off, cnt, _a) = enc
        nxt = succ.get((lo, hi))
        pending.clear()  # at most one prefetch in flight
        if nxt is not None:
            pending[nxt] = _prefetch_ex().submit(_enc, nxt)
        return _rebuild_chunk(
            d16, exc_i, exc_v, c, cexc_i, cexc_v,
            off, jnp.int32(cnt), jnp.int32(lo), doc_sums, plan.avg,
            V, D, chunk_entries, plan.max_docs + 1, plan.nibble,
        )

    return load


_PREFETCH_EX = None


def _prefetch_ex():
    """Process-shared encode/transfer worker pool (lazy; 2 threads so a
    blocked transfer and a numpy encode can overlap without spawning a
    pool per loader)."""
    global _PREFETCH_EX
    if _PREFETCH_EX is None:
        from concurrent.futures import ThreadPoolExecutor

        _PREFETCH_EX = ThreadPoolExecutor(
            max_workers=2, thread_name_prefix="isle-prefetch"
        )
    return _PREFETCH_EX


@partial(jax.jit, static_argnames=("vocab", "n_pad", "max_docs", "nibble"),
         donate_argnums=(0, 1))
def _store_chunk(w_res, c_res, d16, exc_i, exc_v, counts, cexc_i, cexc_v,
                 local_offsets, cnt, a,
                 vocab: int, n_pad: int, max_docs: int, nibble: bool):
    """Resident fill: decode one compact wire chunk's word ids and raw
    counts and write them into the HBM-resident slabs. The slabs are
    DONATED so the update is in place — without donation XLA would copy
    the multi-GB slab once per chunk."""
    from .sparse import decode_word_deltas

    marks = jnp.zeros((n_pad,), jnp.int32).at[local_offsets[1:]].add(
        1, mode="drop"
    )
    dl = jnp.minimum(jnp.cumsum(marks), max_docs - 1)
    in_range = jnp.arange(n_pad, dtype=jnp.int32) < cnt
    w = decode_word_deltas(d16, exc_i, exc_v, None, in_range, vocab,
                           doc_of_entry=dl, offsets=local_offsets)
    if nibble:
        lo_n = (counts & 15).astype(c_res.dtype)
        hi_n = (counts >> 4).astype(c_res.dtype)
        c = jnp.stack([lo_n, hi_n], axis=1).reshape(n_pad)
        c = c.at[cexc_i].set(cexc_v.astype(c_res.dtype), mode="drop")
    else:
        c = counts.astype(c_res.dtype)
    w_res = jax.lax.dynamic_update_slice(w_res, w, (a,))
    c_res = jax.lax.dynamic_update_slice(c_res, c, (a,))
    return w_res, c_res


@partial(jax.jit, donate_argnums=(0, 1))
def _store_chunk_vals(w_res, v_res, w, v, a):
    return (
        jax.lax.dynamic_update_slice(w_res, w, (a,)),
        jax.lax.dynamic_update_slice(v_res, v, (a,)),
    )


@partial(jax.jit, static_argnames=("vocab", "num_docs", "chunk", "mdoc",
                                   "counts_form"))
def _resident_load(w_res, cv_res, offsets_pad, doc_sums, avg, a, lo, cnt,
                   vocab: int, num_docs: int, chunk: int, mdoc: int,
                   counts_form: bool):
    """Decode one chunk from the resident slabs: doc ids from the offsets
    window (the +1-marker cumsum, as _rebuild_chunk), values either
    recomputed as avg * (count / doc_sum) in f32 (counts form — the same
    expression, in the same order, as the wire loaders) or read verbatim
    (vals form). One compiled program serves every chunk of every pass
    (chunk params are operands, shapes static)."""
    w = jax.lax.dynamic_slice(w_res, (a,), (chunk,))
    cv = jax.lax.dynamic_slice(cv_res, (a,), (chunk,))
    loff = jax.lax.dynamic_slice(offsets_pad, (lo,), (mdoc,)) - a
    marks = jnp.zeros((chunk,), jnp.int32).at[loff[1:]].add(1, mode="drop")
    dl = jnp.cumsum(marks)
    in_range = jnp.arange(chunk, dtype=jnp.int32) < cnt
    d = jnp.where(in_range, jnp.minimum(lo + dl, num_docs), num_docs)
    w = jnp.where(in_range, w, vocab)
    if counts_form:
        ds = jnp.concatenate([doc_sums, jnp.ones((1,), jnp.float32)])
        v = jnp.where(w < vocab, avg * (cv.astype(jnp.float32) / ds[d]), 0.0)
    else:
        v = jnp.where(in_range, cv, 0.0)
    return w, v, d


def _pipeline_fill(items, prep, consume, depth=3, workers=2):
    """Producer/consumer pipeline for the resident fill: prep(item)
    (host encode + transfer initiation) runs up to `depth` ahead on
    `workers` threads while consume(result) dispatches the in-order
    donated slab store on the caller's thread. Two workers let one
    thread sit in a blocked transfer while the other runs the numpy
    encode; ordering is preserved because results are consumed FIFO."""
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor
    from itertools import islice

    it = iter(items)
    with ThreadPoolExecutor(max_workers=workers) as ex:
        futs = deque(ex.submit(prep, x) for x in islice(it, depth))
        while futs:
            res = futs.popleft().result()
            nxt = next(it, None)
            if nxt is not None:
                futs.append(ex.submit(prep, nxt))
            consume(res)


class ResidentLoader:
    """Device-RESIDENT compact corpus for the streamed pipeline.

    The per-pass loaders re-pay the host->device transfer for every pass
    (6 passes). This loader uploads the corpus ONCE into device-resident slabs
    and decodes chunks on device for every later pass:

      - counts form (~5 B/entry; 3.9 GB at PubMed): word ids int32 +
        raw counts in the smallest dtype; values recompute
        avg * (count / doc_sum) per load — bitwise the per-pass compact
        loader's expression.
      - vals form (8 B/entry): word ids int32 + f32 values verbatim,
        when raw counts are unusable (custom normalization etc.).

    Doc ids always derive from the resident (D+1) offsets table. The
    fill is lazy (checkpoint resumes that skip every corpus pass never
    pay the upload). Returns per-chunk (w, v, d) exactly like
    make_chunk_loader — drop-in for every streamed stage."""

    def __init__(self, corpus: Corpus, chunk_entries: int, plan="auto"):
        self.corpus = corpus
        self.chunk = chunk_entries
        self._plan = (_compact_plan(corpus, chunk_entries)
                      if plan == "auto" else plan)
        self._filled = False

    @staticmethod
    def resident_bytes(corpus: Corpus, chunk_entries: int, plan) -> int:
        csize = np.dtype(plan.cdtype).itemsize if plan is not None else 4
        slab = int(corpus.nnz) + chunk_entries
        return slab * (4 + csize) + 8 * (corpus.num_docs + 8)

    def _max_docs(self) -> int:
        if self._plan is not None:
            return self._plan.max_docs
        m = 1
        for lo, hi in doc_chunks(self.corpus, self.chunk):
            m = max(m, hi - lo)
        return m

    def _ensure(self):
        if self._filled:
            return
        import time as _time

        t0 = _time.perf_counter()
        corpus, chunk = self.corpus, self.chunk
        D, V = corpus.num_docs, corpus.vocab_size
        total = int(corpus.offsets[D]) + chunk  # slack: final store window
        self._mdoc = self._max_docs() + 1
        off = np.full(D + self._mdoc + 1, corpus.offsets[D], np.int64)
        off[: D + 1] = corpus.offsets
        self._off = jnp.asarray(off.astype(np.int32))
        self._counts_form = self._plan is not None
        if self._counts_form:
            plan = self._plan
            self._ds = jnp.asarray(corpus.doc_sums())
            self._avg = plan.avg
            state = [jnp.full((total,), V, jnp.int32),
                     jnp.zeros((total,), plan.cdtype)]

            def prep(lohi):
                return _to_device(plan.encode_host(*lohi))

            def consume(enc):
                (d16, exc_i, exc_v, c, cexc_i, cexc_v, loff, cnt, a) = enc
                state[0], state[1] = _store_chunk(
                    state[0], state[1], d16, exc_i, exc_v, c, cexc_i,
                    cexc_v, loff, jnp.int32(cnt), jnp.int32(a),
                    V, chunk, plan.max_docs + 1, plan.nibble,
                )

            _pipeline_fill(doc_chunks(corpus, chunk), prep, consume)
            self._w, self._cv = state
        else:
            self._ds = jnp.zeros((D,), jnp.float32)  # unused operand
            self._avg = np.float32(0.0)
            state = [jnp.full((total,), V, jnp.int32),
                     jnp.zeros((total,), jnp.float32)]

            def prep_v(lohi):
                lo, hi = lohi
                a, b = corpus.offsets[lo], corpus.offsets[hi]
                w = jnp.asarray(np.pad(
                    corpus.rows[a:b].astype(np.int32),
                    (0, chunk - (b - a)), constant_values=V,
                ))
                v = jnp.asarray(np.pad(corpus.vals[a:b],
                                       (0, chunk - (b - a))))
                return w, v, int(a)

            def consume_v(res):
                w, v, a = res
                state[0], state[1] = _store_chunk_vals(
                    state[0], state[1], w, v, jnp.int32(a)
                )

            _pipeline_fill(doc_chunks(corpus, chunk), prep_v, consume_v)
            self._w, self._cv = state
        self._filled = True
        # dispatch is async; this is encode+dispatch time, the transfer
        # drains into the first consuming pass
        self.fill_seconds = getattr(self, "fill_seconds", 0.0) + (
            _time.perf_counter() - t0
        )
        self.fill_count = getattr(self, "fill_count", 0) + 1

    def release(self):
        """Free the resident slabs (multi-GB of device memory). The next load
        refills lazily. The streamed trainer only releases when the
        hybrid/eigen/k-means middle cannot fit beside the slabs even
        with a shrunken dense head (plan_middle_budget) — the refill
        re-pays the full corpus encode + upload, which at PubMed costs
        more than the head saves. Two fills still beat six per-pass
        uploads when a release is unavoidable."""
        if self._filled:
            del self._w, self._cv, self._off, self._ds
            self._filled = False

    def __call__(self, lo: int, hi: int):
        self._ensure()
        a = int(self.corpus.offsets[lo])
        cnt = int(self.corpus.offsets[hi]) - a
        return _resident_load(
            self._w, self._cv, self._off, self._ds, self._avg,
            jnp.int32(a), jnp.int32(lo), jnp.int32(cnt),
            self.corpus.vocab_size, self.corpus.num_docs,
            self.chunk, self._mdoc, self._counts_form,
        )


# Middle-stage memory planning constants. The hybrid build's peak
# temporaries at the PubMed shape measured >= ~94 B per nnz(B) alongside
# the full head (dual-sorted B, pad plans, compacted octet tails,
# fragmentation): slabs 3.9 GB + head 4.3 GB did not fit a 16 GB device.
# The no-head middle holds only B itself (~24 B/nnz) plus the
# eigensolver/k-means state.
_MIDDLE_TEMP_B_PER_NNZ = 96
_MIDDLE_NOHEAD_B_PER_NNZ = 30
_MIDDLE_RESERVE = 1 << 30
_MIN_HEAD_BYTES = 256 << 20


def plan_middle_budget(hbm_bytes: Optional[int], slab_bytes: int,
                       nnz_b: int, cfg_head_bytes: int) -> Tuple[bool, int]:
    """Decide whether the resident corpus slabs stay held across the
    hybrid/eigen/k-means middle, and with how large a dense head.

    The head saves SpMM time (it moves the Zipf head into dense
    matmuls); releasing the slabs costs a full corpus re-upload for the
    finish passes. So when both cannot fit: first shrink the head into
    the leftover budget, then drop it entirely, and only release the
    slabs when even the no-head middle cannot fit. Returns (keep_slabs,
    head_bytes); head_bytes is the (possibly shrunken) budget to build
    with when keep_slabs, else the caller's configured budget.
    `hbm_bytes` None (no device limit known, DeviceConfig.memory_budget)
    keeps both."""
    if hbm_bytes is None:
        return True, cfg_head_bytes
    room = (hbm_bytes - slab_bytes - _MIDDLE_TEMP_B_PER_NNZ * nnz_b
            - _MIDDLE_RESERVE)
    if cfg_head_bytes > 0 and room >= _MIN_HEAD_BYTES:
        return True, int(min(cfg_head_bytes, room))
    room_nohead = (hbm_bytes - slab_bytes
                   - _MIDDLE_NOHEAD_B_PER_NNZ * nnz_b - _MIDDLE_RESERVE)
    if room_nohead >= 0:
        return True, 0
    return False, cfg_head_bytes


def get_corpus_loader(corpus: Corpus, chunk_entries: int,
                      resident_bytes: int = 0):
    """Pick the streamed-chunk loader: device-resident when the compact
    corpus fits `resident_bytes` of device memory (the upload is then
    paid once for the whole run), per-pass streaming otherwise."""
    if not (resident_bytes and corpus.nnz):
        return make_chunk_loader(corpus, chunk_entries)
    plan = _compact_plan(corpus, chunk_entries)
    if ResidentLoader.resident_bytes(corpus, chunk_entries,
                                     plan) > resident_bytes:
        return make_chunk_loader(corpus, chunk_entries, plan=plan)
    return ResidentLoader(corpus, chunk_entries, plan=plan)


def doc_chunks(corpus: Corpus, target_entries: int) -> Iterator[Tuple[int, int]]:
    """Yield (doc_lo, doc_hi) ranges of ~target_entries nnz each."""
    D = corpus.num_docs
    offsets = corpus.offsets
    max_doc = int(np.diff(offsets).max()) if D else 0
    assert max_doc <= target_entries, (
        f"chunk_entries={target_entries} smaller than the largest doc "
        f"({max_doc} nnz)"
    )
    lo = 0
    while lo < D:
        # largest hi with offsets[hi] - offsets[lo] <= target_entries
        hi = int(
            np.searchsorted(
                offsets, offsets[lo] + target_entries, side="right"
            )
            - 1
        )
        hi = max(min(hi, D), lo + 1)
        yield lo, hi
        lo = hi


@partial(jax.jit, static_argnames=("F",), donate_argnums=(0,))
def _hist_accum(hist_banked, words, vals, F: int):
    """Accumulate into a value-banked histogram (see thresholds.banked_hist
    for the layout rationale): rows = word * nbanks + value // 128."""
    r = jnp.clip(jnp.floor(vals + 0.5).astype(jnp.int32), 0, F)
    nbanks = (F + 1 + 127) // 128
    n = words.shape[0]
    # 2^20-entry sub-chunks bound the one-hot temporary
    chunk = max(min(1 << 20, n), 1)
    while n % chunk:
        chunk //= 2

    def body(acc, args):
        wi, ri = args
        row = wi * nbanks + ri // 128
        # int32 bins (see thresholds._hist_banked: f32 saturates at 2^24)
        return acc.at[row].add(
            jax.nn.one_hot(ri % 128, 128, dtype=jnp.int32)
        ), None

    out, _ = jax.lax.scan(
        body, hist_banked, (words.reshape(-1, chunk), r.reshape(-1, chunk))
    )
    return out


def streamed_thresholds(
    corpus: Corpus, num_topics: int, hyper, chunk_entries: int = 1 << 25,
    loader=None,
) -> Tuple[jax.Array, int]:
    """Stage 1: zeta cutoffs without materializing A on device."""
    V = corpus.vocab_size
    F = freq_bound(corpus.avg_doc_sz)
    load = loader if loader is not None else make_chunk_loader(
        corpus, chunk_entries)
    nbanks = (F + 1 + 127) // 128
    # int32 bins, like _hist_accum's updates and the sharded variants: a
    # float32 accumulator silently stops counting a bin at 2^24 (latent
    # here — per-(word, value) counts are bounded by num_docs — but the
    # f32 init contradicted the invariant every other histogram keeps).
    hist = jnp.zeros(((V + 1) * nbanks, 128), jnp.int32)
    for i, (lo, hi) in enumerate(doc_chunks(corpus, chunk_entries)):
        w, v, _ = load(lo, hi)
        hist = _hist_accum(hist, w, v, F)
        _drain_every(hist, i)
    h = hist.reshape(V + 1, nbanks * 128)[:V, : F + 1].astype(jnp.int32)
    h = h.at[:, 0].set(0)
    zeta, nnz_w = _zeta_from_hist(
        h,
        hyper.count_gr(corpus.nz_docs, num_topics),
        hyper.count_eq(corpus.nz_docs, num_topics),
        jnp,
        few_drop=hyper.few_samples_threshold_drop,
        bad_drop=hyper.bad_threshold_drop,
    )
    return zeta.astype(jnp.float32), int(nnz_w.sum())


@partial(jax.jit, static_argnames=("num_docs",), donate_argnums=(0,))
def _weight_accum(weights, words, vals, docs, zetas, num_docs: int):
    z = jnp.concatenate([zetas, jnp.zeros((1,), jnp.float32)])
    keep = jnp.floor(vals + 0.5) >= jnp.concatenate(
        [zetas, jnp.full((1,), jnp.inf)]
    )[words]
    contrib = jnp.where(keep, z[words], 0.0)
    return weights.at[docs].add(contrib)


def streamed_doc_weights(
    corpus: Corpus, zetas: jax.Array, chunk_entries: int = 1 << 25,
    loader=None,
) -> jax.Array:
    """Stage 2 input: per-doc importance weights (sum of passing zetas,
    src/sparseMatrix.cpp:1383-1397)."""
    D, V = corpus.num_docs, corpus.vocab_size
    weights = jnp.zeros((D + 1,), jnp.float32)
    load = loader if loader is not None else make_chunk_loader(
        corpus, chunk_entries)
    for i, (lo, hi) in enumerate(doc_chunks(corpus, chunk_entries)):
        w, v, d = load(lo, hi)
        weights = _weight_accum(weights, w, v, d, zetas, D)
        _drain_every(weights, i)
    return weights[:D]


@partial(jax.jit, static_argnames=("n_out",))
def _chunk_compact(words, vals, docs, keep, n_out: int):
    pos = jnp.where(keep, jnp.cumsum(keep.astype(jnp.int32)) - 1, n_out)
    kw = jnp.zeros((n_out,), jnp.int32).at[pos].set(words, mode="drop")
    kv = jnp.zeros((n_out,), jnp.float32).at[pos].set(vals, mode="drop")
    kd = jnp.zeros((n_out,), jnp.int32).at[pos].set(docs, mode="drop")
    return kw, kv, kd, keep.sum()


def streamed_build_b(
    corpus: Corpus,
    zetas: jax.Array,
    select_docs: Optional[jax.Array],
    spmm_chunk: int,
    chunk_entries: int = 1 << 25,
    loader=None,
) -> Tuple[DocSparse, np.ndarray]:
    """Stage 3: B (thresholded, sqrt-zeta, doc-renumbered, dual-sorted)
    assembled on device from streamed chunks."""
    D, V = corpus.num_docs, corpus.vocab_size
    zline = jnp.concatenate([zetas, jnp.full((1,), jnp.inf, jnp.float32)])
    sqz = jnp.concatenate([jnp.sqrt(zetas), jnp.zeros((1,), jnp.float32)])
    sel = (
        jnp.concatenate([select_docs, jnp.zeros((1,), bool)])
        if select_docs is not None
        else None
    )
    parts_w, parts_v, parts_d = [], [], []
    total = 0
    load = loader if loader is not None else make_chunk_loader(
        corpus, chunk_entries)
    for lo, hi in doc_chunks(corpus, chunk_entries):
        n_pad = chunk_entries
        w, v, d = load(lo, hi)
        keep = (jnp.floor(v + 0.5) >= zline[w]) & (w < V)
        if sel is not None:
            keep = keep & sel[d]
        kw, kv, kd, cnt = _chunk_compact(w, sqz[w], d, keep, n_pad)
        cnt = int(cnt)
        parts_w.append(kw[:cnt])
        parts_v.append(kv[:cnt])
        parts_d.append(kd[:cnt])
        total += cnt

    npad = max(spmm_chunk, ((total + spmm_chunk - 1) // spmm_chunk) * spmm_chunk)
    dw = jnp.concatenate(parts_w + [jnp.full((npad - total,), V, jnp.int32)])
    dv = jnp.concatenate(parts_v + [jnp.zeros((npad - total,), jnp.float32)])
    dd_glob = jnp.concatenate(
        parts_d + [jnp.full((npad - total,), D, jnp.int32)]
    )
    # doc renumbering over global occupancy. dd_glob is non-decreasing
    # (doc-ordered chunks, order-preserving compaction, pads last), so
    # occupancy comes from kept-prefix sums sampled at doc boundaries
    # via ONE searchsorted — a segment_sum with D+1 segments is the
    # pattern CLAUDE.md flags as compiling pathologically at millions of
    # segments (same derivation as hybrid._select_build_plan_full).
    G = jnp.concatenate([
        jnp.zeros((1,), jnp.int32),
        jnp.cumsum((dd_glob < D).astype(jnp.int32)),
    ])
    bounds = jnp.searchsorted(
        dd_glob, jnp.arange(D + 1, dtype=dd_glob.dtype), side="left"
    )
    kept_before = G[bounds]
    occ = (kept_before[1:] - kept_before[:-1]) > 0
    new_doc = jnp.cumsum(occ.astype(jnp.int32)) - 1
    nz_docs = int(occ.sum())
    original_cols = np.flatnonzero(np.asarray(occ)).astype(np.int32)
    remap = jnp.concatenate([new_doc, jnp.full((1,), nz_docs, jnp.int32)])
    dd = remap[jnp.minimum(dd_glob, D)]
    dd = jnp.where(dd_glob >= D, nz_docs, dd)
    ww, wd, wv = jax.lax.sort((dw, dd, dv), num_keys=2)
    B = DocSparse(
        d_word=dw, d_doc=dd, d_val=dv, w_word=ww, w_doc=wd, w_val=wv,
        vocab=V, num_docs=nz_docs, nnz=total,
    )
    return B, original_cols


def streamed_filter_clustered(
    corpus: Corpus,
    cluster_of_doc: np.ndarray,
    spmm_chunk: int,
    chunk_entries: int = 1 << 25,
    loader=None,
) -> DocSparse:
    """Stage 4 input: the sub-matrix of A restricted to clustered docs
    (global doc ids preserved), as a device DocSparse for rth_highest and
    catchword statistics."""
    D, V = corpus.num_docs, corpus.vocab_size
    cl = jnp.asarray(
        np.concatenate([cluster_of_doc.astype(np.int32), [-1]])
    )
    parts = []
    total = 0
    load = loader if loader is not None else make_chunk_loader(
        corpus, chunk_entries)
    for lo, hi in doc_chunks(corpus, chunk_entries):
        n_pad = chunk_entries
        w, v, d = load(lo, hi)
        keep = (cl[d] >= 0) & (w < V)
        kw, kv, kd, cnt = _chunk_compact(w, v, d, keep, n_pad)
        cnt = int(cnt)
        parts.append((kw[:cnt], kv[:cnt], kd[:cnt]))
        total += cnt
    npad = max(spmm_chunk, ((total + spmm_chunk - 1) // spmm_chunk) * spmm_chunk)
    dw = jnp.concatenate([p[0] for p in parts]
                         + [jnp.full((npad - total,), V, jnp.int32)])
    dv = jnp.concatenate([p[1] for p in parts]
                         + [jnp.zeros((npad - total,), jnp.float32)])
    dd = jnp.concatenate([p[2] for p in parts]
                         + [jnp.full((npad - total,), D, jnp.int32)])
    # rth_highest only reads the doc-sorted arrays; fill the word-sorted
    # slots with the same data (unused there).
    return DocSparse(
        d_word=dw, d_doc=dd, d_val=dv, w_word=dw, w_doc=dd, w_val=dv,
        vocab=V, num_docs=D, nnz=total,
    )


@partial(jax.jit, static_argnames=("k", "num_docs"), donate_argnums=(0,))
def _mass_accum(mass_flat, words, vals, docs, cwt, k: int, num_docs: int):
    """Accumulate into a FLAT ((D+1)*k,) mass carry — a 2D scatter's
    (nnz, 2) index operand can draw a tiled layout that pads 2 -> 128
    lanes (see hybrid.py); the flat index keeps it 1D."""
    t = cwt[words]
    is_cw = t >= 0
    dd = jnp.where(is_cw, docs, num_docs)
    tt = jnp.maximum(t, 0)
    return mass_flat.at[dd * jnp.int32(k) + tt].add(
        jnp.where(is_cw, vals, 0.0)
    )


@partial(jax.jit, static_argnames=("k",), donate_argnums=(0,))
def _model_accum(model, words, vals, docs, W, k: int):
    """Scatter W-row contributions into the model, sub-chunked: gathering
    a whole 2^25-entry streamed chunk at once materializes a
    (chunk, k) f32 intermediate (16 GB at PubMed scale) — scan in 2^21
    pieces instead."""
    n = words.shape[0]
    sub = min(1 << 21, n)
    while n % sub:
        sub //= 2
    nchunks = n // sub

    def body(m, args):
        w_, v_, d_ = args
        rows = jnp.take(W, d_, axis=0, fill_value=0.0) * v_[:, None]
        return m.at[w_].add(rows), None

    m, _ = jax.lax.scan(
        body,
        model,
        (
            words.reshape(nchunks, sub),
            vals.reshape(nchunks, sub),
            docs.reshape(nchunks, sub),
        ),
    )
    return m


def streamed_topic_model(
    corpus: Corpus,
    cw_topic: np.ndarray,
    cluster_of_doc: np.ndarray,
    num_topics: int,
    rank_threshold: int,
    want_top_pairs: bool,
    chunk_entries: int = 1 << 25,
    loader=None,
):
    """Stages 5-6: catchword mass + model accumulation over streamed A.
    Semantics identical to topic_model.construct_topic_model."""
    from .topic_model import model_thresholds, top_two_topics, _contribution_weights

    D, V, k = corpus.num_docs, corpus.vocab_size, num_topics
    cwt = jnp.asarray(np.concatenate([cw_topic.astype(np.int32), [-1]]))
    assert (D + 1) * k < (1 << 31), (
        f"(num_docs+1)*k = {(D + 1) * k} exceeds int32 flat indexing; "
        "use the doc-sharded mesh path"
    )
    chunks = list(doc_chunks(corpus, chunk_entries))
    load = loader if loader is not None else make_chunk_loader(
        corpus, chunk_entries)

    mass = jnp.zeros(((D + 1) * k,), jnp.float32)
    for i, (lo, hi) in enumerate(chunks):
        w, v, d = load(lo, hi)
        mass = _mass_accum(mass, w, v, d, cwt, k, D)
        _drain_every(mass, i)
    # Keep the spill row: mass.reshape(D+1, k)[:D] would MATERIALIZE a
    # second 3.3 GB copy at PubMed scale (observed OOM). Row D is
    # all-zero by construction (non-catchword and padded entries scatter
    # 0.0 there), which every consumer below is transparent to: an extra
    # zero value never changes the rank_threshold-th largest positive,
    # cluster -1 gives it a zero W row, and _model_accum's doc gather
    # reads that zero row for padded entries.
    mass = mass.reshape(D + 1, k)

    has_cw = jax.ops.segment_sum(
        (jnp.asarray(cw_topic) >= 0).astype(jnp.int32),
        jnp.maximum(jnp.asarray(cw_topic), 0),
        num_segments=k,
    ) > 0
    thr = model_thresholds(mass, has_cw, rank_threshold)
    pairs = None
    if want_top_pairs:
        t1, t2, valid = top_two_topics(mass)
        pairs = (t1[:D], t2[:D], valid[:D])
    cl_pad = jnp.asarray(np.concatenate(
        [cluster_of_doc.astype(np.int32), [-1]]
    ))
    W = _contribution_weights(mass, thr, cl_pad)  # donates mass
    del mass  # (D+1, k) f32 — ~3.3 GB at PubMed scale; W reuses the buffer

    model = jnp.zeros((V + 1, k), jnp.float32)
    for i, (lo, hi) in enumerate(chunks):
        w, v, d = load(lo, hi)
        model = _model_accum(model, w, v, d, W, k)
        _drain_every(model, i)
    model = model[:V]
    sums = jnp.sum(model, axis=0)
    model = jnp.where(sums[None, :] != 0.0, model / sums[None, :], model)
    return model, pairs


class StreamedTrainer:
    """Out-of-core variant of Trainer: same pipeline, A streamed from host.
    Use for corpora whose nnz arrays exceed HBM (BASELINE.md's PubMed
    config). API mirrors Trainer for the stages it supports."""

    def __init__(self, config, output_dir: str = ".", quiet: bool = True,
                 chunk_entries: int = 1 << 25):
        from .trainer import Trainer

        self._t = Trainer(config, output_dir=output_dir, quiet=quiet)
        self.chunk_entries = chunk_entries

    def __getattr__(self, name):
        return getattr(self._t, name)

    def train(self, resume: bool = False) -> None:
        """Run the streamed pipeline; resume=True restores completed
        stages from the run directory (same stage files as Trainer, so a
        run can even switch between in-core and streamed modes mid-way) —
        multi-hour out-of-core runs over a flaky device link restart
        without recomputation.

        With device.mesh_shape set, the whole out-of-core pipeline runs
        doc-sharded over the device mesh (streaming_sharded.py): per-shard
        resident slabs, S-way parallel chunk passes, psum'd additive
        accumulators, and the in-core sharded middle on the streamed-built
        B."""
        if self._t.config.device.mesh_devices() > 1:
            from .streaming_sharded import train_sharded_streamed

            return train_sharded_streamed(self, resume=resume)
        from .catchwords import catchword_topic_map, find_catchwords, rth_highest
        from .hybrid import to_hybrid
        from .kmeans import (
            kmeans_init_on_projected,
            run_lloyds_full,
            run_lloyds_projected,
        )
        from .matops import mat_bt_x, mat_gram_x

        t = self._t
        cfg = t.config
        hp = cfg.hyper
        k = cfg.num_topics
        corpus = t.corpus
        D, V = corpus.num_docs, corpus.vocab_size
        key = jax.random.PRNGKey(cfg.seed)
        ce = self.chunk_entries

        ck = t._load_checkpoints() if resume else {}
        if t._restore_model_checkpoint(ck):
            return
        resume_kmeans = "kmeans" in ck
        resume_svd = "svd" in ck
        # One loader shared by every corpus pass: device-resident when it
        # fits the memory budget (upload paid once), per-pass otherwise.
        # Lazy fill: resumed runs that skip all passes never pay it.
        loader = get_corpus_loader(
            corpus, ce, cfg.device.resident_corpus_bytes
        )
        self._loader = loader

        if resume_svd:
            zetas = jnp.asarray(ck["svd"]["zetas"])
            original_cols = ck["svd"]["original_cols"]
            t.original_cols = original_cols
            t.logger.info("resumed thresholds from 'svd' checkpoint")
        else:
            zetas, new_nnz = streamed_thresholds(
                corpus, k, hp, ce, loader=loader)
            t.logger.info(f"Entries above threshold: {new_nnz}")
            t.timer.next("streamed thresholds")

        if resume_kmeans:
            t.centers = ck["kmeans"]["centers"]
            cluster_of_doc = ck["kmeans"]["cluster_of_doc"]
            t.cluster_of_doc = cluster_of_doc
            if resume_svd:
                t.evalues = ck["svd"]["evalues"]
            assign_h = cluster_of_doc[cluster_of_doc >= 0]
            sizes = np.bincount(assign_h, minlength=k).astype(np.int32)
            t.logger.info("resumed clustering from 'kmeans' checkpoint")
            self._finish(corpus, cluster_of_doc, sizes, k, D, hp, cfg, ce,
                         loader)
            return

        select = None
        if cfg.sample_docs:
            if resume_svd:
                # original_cols pins the surviving docs exactly; consume
                # the same key split the sampling branch would, so every
                # later split sees the identical key stream as an
                # uninterrupted run
                key, _ = jax.random.split(key)
                select = jnp.zeros((D,), bool).at[
                    jnp.asarray(original_cols)
                ].set(True)
            else:
                weights = streamed_doc_weights(corpus, zetas, ce,
                                               loader=loader)
                key, sub = jax.random.split(key)
                u = jax.random.uniform(sub, (D,), jnp.float32)
                dice = jnp.where(
                    weights > 0.0,
                    jnp.power(u, 1.0 / jnp.maximum(weights, 1e-30)),
                    0.0,
                )
                pivot = jnp.sort(dice)[::-1][int(cfg.sample_rate * D)]
                select = dice >= pivot
                t.timer.next("streamed doc sampling")

        key, sub = jax.random.split(key)  # keep key schedule aligned
        B, original_cols = streamed_build_b(
            corpus, zetas, select, cfg.device.spmm_chunk, ce, loader=loader
        )
        t.original_cols = original_cols
        t.logger.info(
            f"Columns remaining after thresholding: {B.num_docs} nnz(B): {B.nnz}"
        )
        t.timer.next("streamed B construction")
        # A is not touched again until the finish passes. Releasing the
        # resident slabs here would let the dense head + build
        # temporaries fit at PubMed scale, but the refill for the finish
        # passes re-pays the full corpus encode + upload, while the head
        # only saves middle-stage SpMM time. When both cannot fit, the
        # slabs win: shrink (or drop) the head into the leftover budget
        # (plan_middle_budget). RESOURCE_EXHAUSTED during the middle
        # falls back to releasing the slabs and retrying.
        slab_held = hasattr(loader, "release")
        head_bytes = cfg.device.dense_head_bytes
        if slab_held:
            slab_b = ResidentLoader.resident_bytes(corpus, ce, loader._plan)
            keep, head_bytes = plan_middle_budget(
                cfg.device.memory_budget(), slab_b, B.nnz,
                cfg.device.dense_head_bytes,
            )
            if keep:
                if head_bytes != cfg.device.dense_head_bytes:
                    t.logger.info(
                        f"holding resident corpus ({slab_b >> 20} MiB) "
                        f"through the middle; dense head budget "
                        f"{head_bytes >> 20} MiB"
                    )
            else:
                loader.release()
                slab_held = False
                head_bytes = cfg.device.dense_head_bytes

        key, sub_eig = jax.random.split(key)
        key, sub_seed = jax.random.split(key)
        # survives an OOM retry: the eigensolve is the most expensive
        # middle stage and must not re-run when the first attempt
        # completed it before dying in the hybrid build / k-means
        middle_state: dict = {}

        def run_middle(head_budget: int):
            Bh = B
            if head_budget > 0 and B.num_docs > 0:
                from .hybrid import max_head_rows

                num_head = min(
                    V, head_budget // max(2 * B.num_docs, 1),
                )
                if not cfg.device.break_head_cap:
                    num_head = min(num_head, max_head_rows(B.num_docs))
                if num_head >= 8:
                    from .hybrid import row_scale_from_zetas

                    Bh = to_hybrid(
                        B, int(num_head), chunk=cfg.device.spmm_chunk,
                        row_scale=row_scale_from_zetas(zetas),
                        break_head_cap=cfg.device.break_head_cap,
                    )
            t.timer.next("hybrid layout")

            if resume_svd:
                evalues = ck["svd"]["evalues"]
                U = jnp.asarray(ck["svd"]["U"])
                t.logger.info("resumed eigenvectors from 'svd' checkpoint")
            elif "U" in middle_state:
                evalues, U = middle_state["evalues"], middle_state["U"]
                t.logger.info(
                    "reusing eigenvectors from the pre-OOM attempt"
                )
            else:
                # Shared solver dispatch — honors hyper.eigensolver
                # (block_ks / lanczos / dense) exactly like the in-core
                # mode instead of hardcoding block_ks.
                from .trainer import solve_gram_eigens

                evalues, U, _ = solve_gram_eigens(
                    lambda B_, X: mat_gram_x(B_, X, cfg.device.spmm_chunk),
                    V, k, Bh, cfg, sub_eig, timer=t.timer, logger=t.logger,
                    start_block=t._warm_start_block(V),
                )
                t.timer.next("eigen solve (B B^T)")
                t._checkpoint(
                    "svd", U=np.asarray(U), evalues=evalues,
                    zetas=np.asarray(zetas), original_cols=original_cols,
                )
                middle_state["evalues"], middle_state["U"] = evalues, U

            P = mat_bt_x(Bh, U, cfg.device.spmm_chunk).T
            seeds, centers_lowd, _ = kmeans_init_on_projected(
                P, k, hp.kmeans_init_reps, sub_seed,
                method=hp.kmeans_init_method,
                mcmc_sample_size=hp.kmeansmcmc_sample_size,
            )
            centers_lowd, _ = run_lloyds_projected(
                P, centers_lowd, hp.max_kmeans_lowd_reps
            )
            centers_full = jnp.matmul(
                centers_lowd, U.T, precision=jax.lax.Precision.HIGHEST
            )
            # Full-space k-means honoring kmeans_algo_for_sparse (the
            # in-core dispatch, trainer.py stage 8).
            if hp.kmeans_algo_for_sparse == "elkans":
                from .elkans import run_elkans

                centers_full, assign = run_elkans(
                    Bh, centers_full, hp.max_kmeans_reps, timer=t.timer,
                    chunk=cfg.device.spmm_chunk,
                )
            else:
                centers_full, assign = run_lloyds_full(
                    Bh, centers_full, hp.max_kmeans_reps,
                    chunk=cfg.device.spmm_chunk,
                )
            return evalues, U, centers_full, assign

        try:
            evalues, U, centers_full, assign = run_middle(head_bytes)
        except Exception as e:
            oom = ("RESOURCE_EXHAUSTED" in str(e)
                   or "Ran out of memory" in str(e))
            if not (slab_held and oom):
                raise
            t.logger.warning(
                "middle stages exhausted HBM with the resident corpus "
                "held; releasing the slabs and retrying (the finish "
                "passes will refill)"
            )
            loader.release()
            slab_held = False
            evalues, U, centers_full, assign = run_middle(
                cfg.device.dense_head_bytes
            )
        t.evalues = evalues
        t.centers = np.asarray(centers_full)
        t.timer.next("k-means")

        assign_h = np.asarray(assign)
        cluster_of_doc = np.full(D, -1, np.int32)
        cluster_of_doc[original_cols] = assign_h
        t.cluster_of_doc = cluster_of_doc
        sizes = np.bincount(assign_h, minlength=k).astype(np.int32)
        t._checkpoint("kmeans", centers=t.centers,
                      cluster_of_doc=cluster_of_doc)
        # Free the SVD/k-means device state before the catchword/topic
        # passes: at PubMed scale B's dense head alone is ~4.3 GB and the
        # final stages need ~8-9 GB of (D, k) working set — holding both
        # ran HBM out (observed on the 787M-nnz run). The hybrid form and
        # the projection died with run_middle's scope.
        del B, U, centers_full, assign
        self._finish(corpus, cluster_of_doc, sizes, k, D, hp, cfg, ce,
                     loader)

    def _finish(self, corpus, cluster_of_doc, sizes, k, D, hp, cfg, ce,
                loader=None):
        from .catchwords import catchword_topic_map, find_catchwords, rth_highest

        t = self._t
        r = hp.catchword_rank(
            D, k, cfg.sample_rate if cfg.sample_docs else None
        )
        r = max(r, 1)
        A_sub = streamed_filter_clustered(
            corpus, cluster_of_doc, cfg.device.spmm_chunk, ce, loader=loader
        )
        thr = rth_highest(
            A_sub, jnp.asarray(cluster_of_doc), jnp.asarray(sizes), k, r
        )
        t.catchword_thresholds = np.asarray(thr)
        is_cw = np.asarray(find_catchwords(thr, hp.rho))
        cwt = catchword_topic_map(is_cw)
        t.catchwords = [np.flatnonzero(is_cw[i]) for i in range(k)]
        del A_sub, thr  # ~1 GB of filtered-corpus device arrays
        t.timer.next("streamed catchwords")

        model, pairs = streamed_topic_model(
            corpus, cwt, cluster_of_doc, k,
            hp.model_rank_threshold(D, k),
            want_top_pairs=cfg.compute_edge_topics,
            chunk_entries=ce,
            loader=loader,
        )
        t.model = np.asarray(model)
        extra = {}
        if pairs is not None:
            t.top_pairs = tuple(np.asarray(x) for x in pairs)
            extra = dict(t1=t.top_pairs[0], t2=t.top_pairs[1],
                         valid=t.top_pairs[2])
        t.timer.next("streamed topic model")
        t._checkpoint(
            "model",
            model=t.model,
            is_cw=is_cw,
            catchword_thresholds=t.catchword_thresholds,
            **extra,
        )
        t.is_training_complete = True
