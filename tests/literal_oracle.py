"""Literal, loop-by-loop re-statements of the reference algorithms, used as
test oracles for the vectorized numpy and jax implementations. These follow
the control flow of the C++ (cited per function) as directly as possible and
make no attempt to be fast."""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np


def round_half_away(x: float) -> float:
    return math.floor(x + 0.5)


def thresholds_literal(
    words: np.ndarray,
    vals: np.ndarray,
    vocab_size: int,
    count_gr: int,
    count_eq: int,
    few_drop: bool = False,
    bad_drop: bool = False,
) -> Tuple[np.ndarray, int]:
    """compute_thresholds (src/sparseMatrix.cpp:357-485), FPTYPE branch.

    few_drop / bad_drop restate the FEW_SAMPLES_THRESHOLD_DROP /
    BAD_THRESHOLD_DROP build flags (hyperparams.h:14-25): the reference
    writes FP_MAX as the drop sentinel (:397-401, :460-461); we use
    float32 +inf — both make every `freq >= zeta` comparison false."""
    freqs: List[List[float]] = [[] for _ in range(vocab_size)]
    for w, v in zip(words, vals):
        freqs[int(w)].append(float(v))
    zetas = np.zeros(vocab_size, dtype=np.float32)
    new_nnzs = 0
    for word in range(vocab_size):
        f = sorted(freqs[word], reverse=True)
        f = [round_half_away(x) for x in f]
        f = [x for x in f if x > 0.0]  # truncate rounded zeros (:383-386)
        if len(f) == 0:
            zetas[word] = 1.0  # (:478-480)
            continue
        if count_gr > len(f):  # too few occurrences (:395-411)
            if few_drop:
                zetas[word] = np.inf  # FP_MAX (:397-401)
            else:
                new_nnzs += len(f)
                zetas[word] = 1.0
            continue
        zeta = f[count_gr - 1]
        while True:
            cur = next(i for i, x in enumerate(f) if x <= zeta)  # first == zeta
            nxt = next((i for i, x in enumerate(f) if x < zeta), len(f))
            if nxt - cur < count_eq:  # accepted (:447-451)
                new_nnzs += nxt
                zetas[word] = zeta
                break
            if nxt == len(f) or zeta == 1:  # exhausted (:453-464)
                if bad_drop:
                    zetas[word] = np.inf  # FP_MAX (:460-461)
                else:
                    new_nnzs += len(f)
                    zetas[word] = 1.0
                break
            zeta = f[nxt]
    return zetas, new_nnzs


def rth_highest_literal(
    offsets: np.ndarray,
    rows: np.ndarray,
    vals: np.ndarray,
    vocab_size: int,
    r: int,
    doc_partition: Sequence[int],
) -> np.ndarray:
    """rth_highest_element (src/sparseMatrix.cpp:491-524)."""
    thresholds = np.zeros(vocab_size, dtype=np.float32)
    if len(doc_partition) == 0:
        return thresholds
    freqs: List[List[float]] = [[] for _ in range(vocab_size)]
    for d in doc_partition:
        for pos in range(offsets[d], offsets[d + 1]):
            freqs[int(rows[pos])].append(float(vals[pos]))
    for word in range(vocab_size):
        f = freqs[word]
        if len(f) > r:
            f = sorted(f, reverse=True)
            thresholds[word] = f[r - 1]
        else:
            if r >= len(doc_partition) and len(f) == len(doc_partition):
                thresholds[word] = min(f)
            else:
                thresholds[word] = 0.0
    return thresholds


def find_catchwords_literal(
    thresholds: np.ndarray, rho: float
) -> List[List[int]]:
    """find_catchwords (src/sparseMatrix.cpp:573-594).
    thresholds: (num_topics, vocab) array."""
    num_topics, vocab = thresholds.shape
    out: List[List[int]] = []
    for t in range(num_topics):
        cw = []
        for w in range(vocab):
            ok = num_topics > 1
            for o in range(num_topics):
                if o == t:
                    continue
                if not (thresholds[t, w] > rho * thresholds[o, w]):
                    ok = False
                    break
            if ok:
                cw.append(w)
        out.append(cw)
    return out


def construct_topic_model_literal(
    offsets: np.ndarray,
    rows: np.ndarray,
    vals: np.ndarray,
    vocab_size: int,
    num_docs: int,
    num_topics: int,
    closest_docs: Sequence[Sequence[int]],
    catchwords: Sequence[Sequence[int]],
    eps3: float,
    w0: float,
    want_top_pairs: bool = False,
):
    """construct_topic_model (src/sparseMatrix.cpp:597-838), live code paths
    only. Returns (model[vocab, num_topics] l1-normalized, top_topic_pairs)."""
    model = np.zeros((vocab_size, num_topics), dtype=np.float64)

    cw_topic: Dict[int, int] = {}
    for t in range(num_topics):
        for w in catchwords[t]:
            cw_topic[int(w)] = t  # catchwords are disjoint across topics

    # Per-doc catchword-topic sums (:661-672).
    doc_topic: List[Dict[int, float]] = [dict() for _ in range(num_docs)]
    for d in range(num_docs):
        for pos in range(offsets[d], offsets[d + 1]):
            w = int(rows[pos])
            if w in cw_topic:
                t = cw_topic[w]
                doc_topic[d][t] = doc_topic[d].get(t, 0.0) + float(vals[pos])

    # Top-2 topics per doc (:687-708): strictly-greater max/second-max scan
    # in topic order.
    top_pairs = []
    if want_top_pairs:
        for d in range(num_docs):
            mx = mx2 = 0.0
            mt = mt2 = -1
            for t in sorted(doc_topic[d].keys()):
                v = doc_topic[d][t]
                if v > mx:
                    mx2, mt2 = mx, mt
                    mx, mt = v, t
                elif v > mx2:
                    mx2, mt2 = v, t
            if mt >= 0 and mt2 >= 0:
                top_pairs.append((mt, mt2, d))

    # Per-topic rank threshold (:722-754).
    rank_threshold = int(eps3 * w0 * float(num_docs) / (float(num_topics) * 2.0))
    model_threshold = np.zeros(num_topics, dtype=np.float64)
    for t in range(num_topics):
        if len(catchwords[t]) == 0:
            continue
        sums = sorted(
            (doc_topic[d][t] for d in range(num_docs) if t in doc_topic[d]),
            reverse=True,
        )
        if len(sums) >= rank_threshold and rank_threshold > 0:
            model_threshold[t] = sums[rank_threshold - 1]

    # Accumulate docs above threshold (:806-817) plus every doc into its own
    # cluster topic (:792-821 — the live code adds cluster docs
    # unconditionally, not only for catchless topics).
    cluster_of = np.full(num_docs, -1, dtype=np.int64)
    for t in range(num_topics):
        for d in closest_docs[t]:
            cluster_of[int(d)] = t
    for d in range(num_docs):
        for t, s in doc_topic[d].items():
            if s > model_threshold[t]:
                for pos in range(offsets[d], offsets[d + 1]):
                    model[int(rows[pos]), t] += float(vals[pos])
        if cluster_of[d] != -1:
            t = cluster_of[d]
            for pos in range(offsets[d], offsets[d + 1]):
                model[int(rows[pos]), t] += float(vals[pos])

    # l1 normalize per topic (:828-831).
    for t in range(num_topics):
        s = model[:, t].sum()
        if s != 0.0:
            model[:, t] /= s
    return model.astype(np.float32), top_pairs


def mwu_literal(
    a: np.ndarray,
    M: np.ndarray,
    num_topics: int,
    iters: int,
    Lf: float,
) -> Tuple[np.ndarray, bool]:
    """mwu (src/infer.cpp:397-443): returns (w, converged)."""
    w = np.full(num_topics, 1.0 / num_topics, dtype=np.float32)
    if len(a) == 0:
        return w, False
    for _ in range(10):
        w = np.full(num_topics, 1.0 / num_topics, dtype=np.float32)
        for it in range(iters):
            z = M @ w
            with np.errstate(divide="ignore", invalid="ignore"):
                g = M.T @ (a / z)
            eta = math.sqrt(2.0 * math.log(num_topics) / (it + 1)) / Lf
            w = w * np.exp(eta * g, dtype=np.float32)
            w = w / np.float32(w.sum())
        s = float(w.sum())
        if np.isfinite(s) and s != 0.0 and not np.isnan(s):
            if abs(1.0 - s) <= 0.01:
                return w, True
            # isnormal but off: reference loops with the same Lf (and hence
            # the same result) until guesses are exhausted -> not converged.
            return w, False
        Lf *= 2.0
    return w, False


def elkans_literal(dense, centers, max_reps):
    """Sequential doc-level Elkan's k-means on a dense (V, D) matrix:
    per-iteration assignment sequence oracle for isle_jax.elkans.run_elkans
    (same bound maintenance and doc-level filter ub > s[a] AND
    ub > min_{c != a} lb; reference src/sparseMatrix.cpp:2242-2492 gathers
    the same flagged docs into a mini-CSC). Returns the list of assignment
    arrays, one per iteration (including the initial one)."""
    import numpy as np

    V, D = dense.shape
    k = centers.shape[0]

    def exact(centers):
        d2 = (
            (dense * dense).sum(axis=0)[:, None]
            + (centers * centers).sum(axis=1)[None, :]
            - 2.0 * dense.T @ centers.T
        )
        return np.sqrt(np.maximum(d2, 0.0))

    dist = exact(centers)
    assign = np.argmin(dist, axis=1)
    ub = dist[np.arange(D), assign]
    lb = dist.copy()
    seq = [assign.copy()]
    prev = None
    for rep in range(max_reps):
        sums = np.zeros((k, V))
        counts = np.zeros(k)
        for d in range(D):
            sums[assign[d]] += dense[:, d]
            counts[assign[d]] += 1
        new_centers = np.where(
            counts[:, None] > 0, sums / np.maximum(counts[:, None], 1), 0.0
        )
        move = np.linalg.norm(new_centers - centers, axis=1)
        centers = new_centers
        cc = np.sqrt(
            np.maximum(
                (centers * centers).sum(1)[:, None]
                + (centers * centers).sum(1)[None, :]
                - 2.0 * centers @ centers.T,
                0.0,
            )
        )
        np.fill_diagonal(cc, np.inf)
        s = 0.5 * cc.min(axis=1)
        ub = ub + move[assign]
        lb = np.maximum(lb - move[None, :], 0.0)
        for d in range(D):
            others = np.delete(lb[d], assign[d])
            if ub[d] > s[assign[d]] and ub[d] > others.min():
                row = exact(centers)[d]
                assign[d] = np.argmin(row)
                ub[d] = row[assign[d]]
                lb[d] = row
        seq.append(assign.copy())
        if prev is not None and np.array_equal(assign, prev):
            break
        prev = assign.copy()
    return seq
