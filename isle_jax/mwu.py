"""Batched multiplicative-weight-update (MWU) inference.

Reference semantics (src/infer.cpp:364-493):
  - per doc, words whose total model mass is <= 1e-10 are dropped from the
    slice (:375-386); `words_in_doc` counts ALL words, `nnzs_in_doc` only
    the kept ones.
  - MWU: w starts uniform; per iteration t (0-based),
        grad = M^T (a / (M w)),  eta = sqrt(2 ln k / (t+1)) / Lf,
        w <- normalize(w * exp(eta * grad))            (:417-427)
    after `iters` iterations, converged iff sum(w) is a normal float within
    1% of 1 (:429-441); on non-finite sums Lf doubles and the whole run
    retries, up to 10 guesses; a finite-but-off sum retries with the SAME
    Lf (and therefore the same outcome) — i.e. it is simply unconverged.
  - log-likelihood (:469-493): s = sum_d a_d log((M w)_d);
    llh_per_doc = s * avg_doc_sz of the inference corpus,
    llh_weighted = s * words_in_doc. Unconverged docs report (0, 0).

Device design: docs are padded to a common nnz width and processed in
blocks; the model rows for a block are gathered ONCE and reused across all
MWU iterations and Lf retries (they do not depend on w). The per-doc
contractions are batched matvecs, which have no matrix-unit shape — so
they run as fp32 elementwise multiply+reduce (z = sum_k Mb*w, grad =
sum_l Mb*ratio), memory-bandwidth-bound on streaming Mb. The Lf-doubling retry
runs vectorized with a per-doc Lf and converged mask.
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

MAX_NNZS = 20000  # include/infer.h:52


@dataclasses.dataclass
class InferBatch:
    """Host-side padded layout of the inference corpus.

    When `counts`/`doc_sums` are present (raw counts fit uint16 and the
    corpus is exactly unit-mass normalized), blocks upload word ids +
    uint16 counts + per-doc sums (~6 B/slot) and the device rebuilds
    a = count/doc_sum bit-identically, cutting the host->device bytes
    per slot from 8 to ~3."""

    word_idx: np.ndarray  # (num_docs, L) int32, pad = vocab
    a: np.ndarray  # (num_docs, L) float32, pad = 0
    words_in_doc: np.ndarray  # (num_docs,) int32 (pre-filter count)
    num_docs: int
    avg_doc_sz: float
    counts: np.ndarray = None  # (num_docs, L) uint8/uint16 or None
    doc_sums: np.ndarray = None  # (num_docs,) float32 or None


def build_infer_batch(corpus, model_mass: np.ndarray, pad_to: int = 8) -> InferBatch:
    """Pack a normalized-to-one corpus into padded per-doc arrays, dropping
    words with model mass <= 1e-10 (src/infer.cpp:375-386)."""
    offsets, rows, vals = corpus.offsets, corpus.rows, corpus.vals
    D, V = corpus.num_docs, corpus.vocab_size
    keep = model_mass[rows] > 1e-10
    lengths = np.diff(offsets)
    # kept-prefix sums; cumsum over int32, NOT bool (numpy's bool cumsum
    # is ~15x slower at this scale)
    csum = np.cumsum(keep.astype(np.int32))
    csum_ext = np.concatenate([[0], csum])
    kept_len = csum_ext[offsets[1:]] - csum_ext[offsets[:-1]]
    L = int(max(kept_len.max() if D else 0, 1))
    L = ((L + pad_to - 1) // pad_to) * pad_to
    assert L < MAX_NNZS, f"doc with {L} nnz exceeds MAX_NNZS={MAX_NNZS}"

    word_idx = np.full((D, L), V, np.int32)
    a = np.zeros((D, L), np.float32)
    doc_ids = np.repeat(np.arange(D, dtype=np.int32), lengths)
    # position within the doc among KEPT entries (gather beats a second
    # varying-length repeat)
    within = csum - 1 - csum_ext[offsets[:-1]][doc_ids]
    kd = doc_ids[keep]
    kw = within[keep]
    word_idx[kd, kw] = rows[keep]
    a[kd, kw] = vals[keep]

    # Compact-upload sidecar: raw counts + per-doc sums, if they exactly
    # reproduce vals (unit-mass normalization) and fit uint16. The
    # integrality check is global — a sampled check could miss rare
    # fractional counts the uint16 cast would truncate — and vals_match
    # compares what the DEVICE will compute, including the cast.
    counts_p = doc_sums = None
    if (
        corpus.counts is not None
        and len(rows)
        and float(corpus.counts.max()) < 65536.0
        and bool(np.all(corpus.counts == np.floor(corpus.counts)))
    ):
        # u8 when every count fits (typical bag-of-words): halves the
        # per-slot count bytes on the upload-bound link.
        cdtype = (
            np.uint8 if float(corpus.counts.max()) < 256.0 else np.uint16
        )
        if corpus.vals_match(
            lambda c, ds: c.astype(cdtype).astype(np.float32) / ds
        ):
            counts_p = np.zeros((D, L), cdtype)
            counts_p[kd, kw] = corpus.counts[keep].astype(cdtype)
            doc_sums = corpus.doc_sums()

    return InferBatch(
        word_idx=word_idx,
        a=a,
        words_in_doc=lengths.astype(np.int32),
        num_docs=D,
        avg_doc_sz=corpus.avg_doc_sz,
        counts=counts_p,
        doc_sums=doc_sums,
    )


def _mwu_core(
    Mw: jax.Array,  # (V+1, k) model with zero spill row
    word_idx: jax.Array,  # (bs, L)
    a: jax.Array,  # (bs, L)
    iters: int,
    Lf0: jax.Array,  # scalar
    max_guesses: int,
):
    bs, L = word_idx.shape
    k = Mw.shape[1]
    Mb = Mw[word_idx]  # (bs, L, k) gathered once
    has_words = jnp.sum(a > 0, axis=1) > 0

    log_k = jnp.float32(math.log(k))

    # The contractions are batched MATVECS (each doc has its own model
    # slice): explicit multiply+reduce in true fp32, which no matmul
    # precision setting can demote (the reference's sgemv is plain fp32
    # too, src/infer.cpp:445-467).
    def _z(w):
        return jnp.sum(Mb * w[:, None, :], axis=2)  # (bs, L)

    def _grad(ratio):
        return jnp.sum(Mb * ratio[:, :, None], axis=1)  # (bs, k)

    def run(Lf):  # Lf: (bs,)
        w = jnp.full((bs, k), 1.0 / k, jnp.float32)

        def it_body(t, w):
            z = _z(w)
            ratio = jnp.where(a > 0, a / z, 0.0)
            g = _grad(ratio)
            eta = jnp.sqrt(2.0 * log_k / (t + 1).astype(jnp.float32)) / Lf
            w = w * jnp.exp(eta[:, None] * g)
            w = w / jnp.sum(w, axis=1, keepdims=True)
            return w

        return jax.lax.fori_loop(0, iters, it_body, w)

    def guess_body(state):
        _, w, conv, Lf, g = state
        w_new = run(Lf)
        s = jnp.sum(w_new, axis=1)
        finite = jnp.isfinite(s) & (s != 0.0)
        ok = finite & (jnp.abs(1.0 - s) <= 0.01) & has_words
        # finite-but-off docs never converge (same Lf -> same result);
        # non-finite docs double Lf and retry.
        newly = ok & (~conv)
        w = jnp.where(newly[:, None], w_new, w)
        settled = conv | ok | (finite & (jnp.abs(1.0 - s) > 0.01)) | ~has_words
        Lf = jnp.where(settled, Lf, Lf * 2.0)
        return settled.all(), w, conv | ok, Lf, g + 1

    def guess_cond(state):
        all_settled, _, _, _, g = state
        return (~all_settled) & (g < max_guesses)

    init = (
        jnp.bool_(False),
        jnp.full((bs, k), 1.0 / k, jnp.float32),
        jnp.zeros((bs,), bool),
        jnp.full((bs,), Lf0, jnp.float32),
        jnp.int32(0),
    )
    _, w, conv, _, _ = jax.lax.while_loop(guess_cond, guess_body, init)

    z = _z(w)
    logz = jnp.where(a > 0, jnp.log(z), 0.0)
    s = jnp.sum(a * logz, axis=1)
    return w, conv, s


@partial(jax.jit, static_argnames=("iters", "max_guesses"))
def _mwu_block(Mw, word_idx, a, iters: int, Lf0, max_guesses: int):
    return _mwu_core(Mw, word_idx, a, iters, Lf0, max_guesses)


@partial(jax.jit, static_argnames=("n",))
def _block_topn(w, n: int):
    """Device-side top-n per row (ties break to the lowest index, the
    same order as a stable descending argsort)."""
    return jax.lax.top_k(w, n)


@partial(jax.jit, static_argnames=("iters", "max_guesses"))
def _mwu_block_compact(Mw, wdelta, exc_i, exc_v, counts, doc_sums,
                       iters: int, Lf0, max_guesses: int):
    """Compact-upload block: word ids arrive as u16 row deltas (ids are
    ascending within a doc; pad slots repeat the last word, which is
    harmless — their count/a is 0 so neither grad nor llh reads them)
    with >65534 jumps in a tiny exception list, and a = count / doc_sum
    is rebuilt on device (the same f32 expression Corpus.from_entries
    used, so bit-identical to the host-packed `a`). Halves the dominant
    word-id upload (4 -> 2 B/slot)."""
    d = wdelta.astype(jnp.int32).reshape(-1)
    d = d.at[exc_i].set(exc_v, mode="drop")
    word_idx = jnp.cumsum(d.reshape(wdelta.shape), axis=1)
    a = counts.astype(jnp.float32) / doc_sums[:, None]
    return _mwu_core(Mw, word_idx, a, iters, Lf0, max_guesses)


def _encode_row_deltas(wi: np.ndarray, V: int):
    """(bs, L) int32 word ids (pads == V, pads are a row suffix) ->
    (u16 deltas, exception flat idx int32, exception values int32).
    Pad slots decode to the row's last real word (or 0 for empty rows)."""
    bs, L = wi.shape
    valid = wi < V
    kept_n = valid.sum(axis=1)
    last = wi[np.arange(bs), np.maximum(kept_n - 1, 0)]
    last = np.where(kept_n > 0, last, 0).astype(np.int32)
    wclean = np.where(valid, wi, last[:, None]).astype(np.int32)
    delta = wclean.copy()
    delta[:, 1:] -= wclean[:, :-1]
    flat = delta.reshape(-1)
    exc = np.flatnonzero(flat.view(np.uint32) > 65534)
    d16 = flat.astype(np.uint16).reshape(bs, L)
    # pow2-padded exceptions (floored so blocks share a jit entry);
    # pad idx points past the array -> dropped by the device scatter.
    cap = max(256, 1 << (max(len(exc), 1) - 1).bit_length())
    exc_i = np.full(cap, bs * L, np.int32)
    exc_v = np.zeros(cap, np.int32)
    exc_i[: len(exc)] = exc
    exc_v[: len(exc)] = flat[exc]
    return d16, exc_i, exc_v


def infer_all(
    model: np.ndarray,  # (vocab, k) column-l1-normalized topic model
    batch: InferBatch,
    iters: int,
    Lf: float,
    block_size: int = 0,
    max_guesses: int = 10,
    mesh=None,
    top_n: int = 0,
):
    """Run MWU over every doc. Returns (weights (D, k), converged (D,),
    llh_per_doc (D,), llh_weighted (D,)). Unconverged docs keep uniform
    weights and zero llh (drivers/ISLEInfer.cpp:95-111 behavior).

    With top_n > 0, only each doc's top_n weights download from the
    device (the reference CLI writes at most the top 5 per doc,
    drivers/ISLEInfer.cpp:100-111) — the rest of each converged row is
    0.0 filler (NOT 1/k: a value-equality sentinel would depend on exact
    float32 promotion in consumers; 0.0 is unambiguously below the
    `> 1/k` report cut). At 300k docs the full (D, k) readback is
    ~120 MB; the top-5 form is ~7 MB.

    With `mesh` (a 1-D jax Mesh), each block's doc rows shard across the
    mesh and the model replicates — the multi-chip form of the reference's
    parallel-for over 1M-doc blocks (drivers/ISLEInfer.cpp:64-117). The
    MWU math is purely row-parallel, so GSPMD partitions it with zero
    collectives; results are identical to the single-device path."""
    V, k = model.shape
    D, L = batch.word_idx.shape
    top_n = min(top_n, k)
    Mw = jnp.concatenate(
        [jnp.asarray(model, jnp.float32), jnp.zeros((1, k), jnp.float32)]
    )
    sh_rows = sh_rep = None
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        sh_rows = NamedSharding(mesh, P(mesh.axis_names[0]))
        sh_rep = NamedSharding(mesh, P())
        Mw = jax.device_put(Mw, sh_rep)
    weights = np.full((D, k), 1.0 / k, np.float32)
    conv = np.zeros(D, bool)
    s_all = np.zeros(D, np.float32)
    Lf0 = jnp.float32(Lf)

    # Bucket docs by kept length: the padded layout is front-loaded, so a
    # doc with n kept words only needs the first n columns; docs far below
    # the bucket edge waste upload bytes and compute otherwise. Fine edges
    # (multiples of 64 through 512) keep padding waste ~1.2x vs the ~2.6x
    # of coarse power-of-4 buckets; slots are upload bytes and compute.
    kept = (batch.word_idx < V).sum(axis=1)
    fine = [64, 128, 192, 256, 320, 384, 448, 512, 1024, 2048, 8192]
    edges = [e for e in fine if e < L] + [L]
    # Compact uploads work under a mesh too: the u16 counts / doc-sum
    # arrays shard row-wise exactly like the fat f32 arrays would, so
    # multi-device inference keeps the same ~3 B/slot upload as
    # single-device.
    compact = batch.counts is not None
    pending = []
    prev = -1
    for edge in edges:
        sel = np.flatnonzero((kept > prev) & (kept <= edge))
        prev = edge
        if len(sel) == 0:
            continue
        bs_cap = block_size
        if bs_cap <= 0:
            # keep the gathered block under ~2 GiB
            bs_cap = max(1, min(len(sel), (1 << 29) // max(edge * k, 1)))
            bs_cap = int(2 ** math.floor(math.log2(bs_cap)))
        if mesh is not None:
            # row-sharded device_put requires bs_cap % n_devices == 0
            n_dev = int(mesh.devices.size)
            bs_cap = ((max(bs_cap, n_dev) + n_dev - 1) // n_dev) * n_dev
        for lo in range(0, len(sel), bs_cap):
            idx = sel[lo : lo + bs_cap]
            bs = len(idx)
            wi = batch.word_idx[idx, :edge]
            if bs < bs_cap:  # pad the tail block to the static shape
                wi = np.concatenate(
                    [wi, np.full((bs_cap - bs, edge), V, np.int32)]
                )
            if compact:
                cn = batch.counts[idx, :edge]
                ds = batch.doc_sums[idx]
                if bs < bs_cap:
                    cn = np.concatenate(
                        [cn, np.zeros((bs_cap - bs, edge), cn.dtype)]
                    )
                    ds = np.concatenate(
                        [ds, np.ones(bs_cap - bs, np.float32)]
                    )
                d16, exc_i, exc_v = _encode_row_deltas(wi, V)
                if mesh is not None:
                    d16 = jax.device_put(d16, sh_rows)
                    cn = jax.device_put(cn, sh_rows)
                    ds = jax.device_put(ds, sh_rows)
                    exc_i = jax.device_put(exc_i, sh_rep)
                    exc_v = jax.device_put(exc_v, sh_rep)
                w, c, s = _mwu_block_compact(
                    Mw, jnp.asarray(d16), jnp.asarray(exc_i),
                    jnp.asarray(exc_v), jnp.asarray(cn), jnp.asarray(ds),
                    iters, Lf0, max_guesses,
                )
                pending.append(
                    (idx, bs, _block_topn(w, top_n) if top_n else w, c, s)
                )
                continue
            else:
                av = batch.a[idx, :edge]
                if bs < bs_cap:
                    av = np.concatenate(
                        [av, np.zeros((bs_cap - bs, edge), np.float32)]
                    )
                if mesh is not None:
                    wi = jax.device_put(wi, sh_rows)
                    av = jax.device_put(av, sh_rows)
                w, c, s = _mwu_block(
                    Mw, jnp.asarray(wi), jnp.asarray(av), iters, Lf0,
                    max_guesses,
                )
            pending.append(
                (idx, bs, _block_topn(w, top_n) if top_n else w, c, s)
            )
    # One pipeline flush instead of a sync per block: dispatch is async,
    # so all uploads/compute/downloads overlap and the per-block readback
    # round trips collapse into one.
    for idx, bs, w, c, s in pending:
        if top_n:
            tv, ti = (np.asarray(x)[:bs] for x in w)
            rows = np.zeros((bs, k), np.float32)
            np.put_along_axis(rows, ti.astype(np.int64), tv, axis=1)
            weights[idx] = rows
        else:
            weights[idx] = np.asarray(w)[:bs]
        conv[idx] = np.asarray(c)[:bs]
        s_all[idx] = np.asarray(s)[:bs]
    llh_doc = np.where(conv, s_all * np.float32(batch.avg_doc_sz), 0.0)
    llh_weighted = np.where(conv, s_all * batch.words_in_doc, 0.0)
    weights = np.where(conv[:, None], weights, np.float32(1.0 / k))
    return weights, conv, llh_doc, llh_weighted
