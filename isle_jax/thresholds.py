"""Per-word frequency thresholds (the ζ_w cutoffs).

Reference semantics (src/sparseMatrix.cpp:357-485 `compute_thresholds`):
normalized per-doc frequencies are rounded half-away-from-zero to integers,
zeros dropped; with
    count_gr = max(1, int(w0 * nz_docs / (2 k)))      (:370)
    count_eq = max(1, ceil(3 eps1 w0 nz_docs / k))    (:371)
the search starts at the count_gr-th largest rounded value and walks DOWN
through the distinct values present, accepting the first value v whose tie
count #(freqs == v) < count_eq. Words with fewer than count_gr occurrences,
words where the walk exhausts all values (or reaches v == 1 unaccepted), and
absent words all get ζ = 1 ("throw everything in",
src/sparseMatrix.cpp:395-411, 428-439). The per-word contribution to the
post-threshold nnz count is #(freqs >= ζ).

Device design: because every rounded value lies in [1, round(avg_doc_sz)
+ 1] (each normalized value is <= avg_doc_sz; asserted at
src/sparseMatrix.cpp:381), the whole computation collapses to a (vocab x
max_freq) histogram, a reversed cumulative sum, and row-wise masked maxima —
no per-word sorting, no data-dependent loops. The accepted ζ equals the
LARGEST present value v <= ζ_start with tie-count < count_eq (the downward
walk stops only at the bottom, where the fallback also yields 1), which a
masked argmax computes directly.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


def round_half_away(x: np.ndarray) -> np.ndarray:
    """std::round for non-negative inputs (numpy rounds half-to-even)."""
    return np.floor(x + 0.5)


def freq_bound(avg_doc_sz: float) -> int:
    """Static upper bound on rounded normalized frequencies."""
    return int(np.floor(avg_doc_sz + 0.5)) + 1


def _zeta_from_hist(hist, count_gr: int, count_eq: int, xp,
                    few_drop: bool = False, bad_drop: bool = False):
    """Shared vectorized ζ selection given a (vocab, F+1) histogram whose
    column v counts entries that round to v (column 0 already zeroed).

    few_drop / bad_drop flip the reference's FEW_SAMPLES_THRESHOLD_DROP /
    BAD_THRESHOLD_DROP build flags (hyperparams.h:14-25): the affected
    words get ζ = +inf (the reference writes FP_MAX / 1<<31 — any
    unreachable sentinel; comparisons `freq >= ζ` then drop the word) and
    contribute 0 to the post-threshold nnz. Absent words keep ζ = 1
    unconditionally (src/sparseMatrix.cpp:477-480 is outside both flags)."""
    F1 = hist.shape[1]
    # n_ge[:, v] = #(rounded freqs >= v)
    n_ge = xp.cumsum(hist[:, ::-1], axis=1)[:, ::-1]
    size = n_ge[:, 1] if F1 > 1 else xp.zeros(hist.shape[0], hist.dtype)
    v_idx = xp.arange(F1)
    # zeta_start: the count_gr-th largest value = max v with n_ge[v] >= count_gr.
    start = xp.max(xp.where(n_ge >= count_gr, v_idx[None, :], 0), axis=1)
    eligible = (
        (hist > 0)
        & (hist < count_eq)
        & (v_idx[None, :] <= start[:, None])
        & (v_idx[None, :] >= 1)
    )
    zeta = xp.max(xp.where(eligible, v_idx[None, :], 0), axis=1)
    absent = size == 0
    too_few = (count_gr > size) & ~absent  # checked first (:395, continue)
    exhausted = (zeta == 0) & ~too_few & ~absent  # walk fallback (:428-439)
    zeta = xp.where(zeta == 0, 1, zeta)  # exhausted walk -> throw all in
    zeta = xp.where(too_few, 1, zeta)  # too few samples
    zeta = xp.where(absent, 1, zeta)  # absent word
    nnz_per_word = xp.take_along_axis(
        n_ge, xp.minimum(zeta, F1 - 1)[:, None], axis=1
    )[:, 0]
    nnz_per_word = xp.where(absent, 0, nnz_per_word)
    if few_drop or bad_drop:
        drop = (too_few & few_drop) | (exhausted & bad_drop)
        zeta = xp.where(drop, xp.inf, zeta.astype(xp.float32))
        nnz_per_word = xp.where(drop, 0, nnz_per_word)
    return zeta, nnz_per_word


def compute_thresholds_np(
    words: np.ndarray,
    vals: np.ndarray,
    vocab_size: int,
    avg_doc_sz: float,
    nz_docs: int,
    num_topics: int,
    hyper,
) -> Tuple[np.ndarray, int]:
    """Vectorized numpy ζ computation. Returns (zetas float32[vocab], nnz)."""
    count_gr = hyper.count_gr(nz_docs, num_topics)
    count_eq = hyper.count_eq(nz_docs, num_topics)
    F = freq_bound(avg_doc_sz)
    r = round_half_away(vals).astype(np.int64)
    np.clip(r, 0, F, out=r)
    hist = np.zeros((vocab_size, F + 1), dtype=np.int64)
    np.add.at(hist, (words.astype(np.int64), r), 1)
    hist[:, 0] = 0
    zeta, nnz_w = _zeta_from_hist(
        hist, count_gr, count_eq, np,
        few_drop=hyper.few_samples_threshold_drop,
        bad_drop=hyper.bad_threshold_drop,
    )
    return zeta.astype(np.float32), int(nnz_w.sum())


def banked_hist(
    words: jax.Array,
    r: jax.Array,
    num_rows: int,
    F: int,
    chunk: int = 1 << 20,
) -> jax.Array:
    """(num_rows, F+1) int32 histogram of integer values r in [0, F]
    keyed by `words`, as chunked 128-wide one-hot scatters.

    Two compile/runtime hazards shape this: a flat segment_sum over
    rows*(F+1) scalar bins with millions of segments compiles
    pathologically, and very wide one-hot rows scatter slowly. So
    the value axis splits into 128-wide banks — scatter row index =
    word * nbanks + r // 128, one-hot lane = r % 128 — reshaped back at
    the end."""
    import math as _math

    n = words.shape[0]
    nbanks = (F + 1 + 127) // 128
    chunk = 1 << min(int(_math.log2(chunk)), int(_math.log2(n)))
    while n % chunk:
        chunk //= 2
    nchunks = n // chunk

    def body(acc, args):
        w, rr = args
        row = w * nbanks + rr // 128
        # int32 bins: a float32 accumulator silently stops counting a
        # bin at 2^24 entries (x + 1.0 == x), undercounting thresholds
        # on >16.7M-doc corpora with no error.
        g = jax.nn.one_hot(rr % 128, 128, dtype=jnp.int32)
        return acc.at[row].add(g), None

    hist_f, _ = jax.lax.scan(
        body,
        jnp.zeros((num_rows * nbanks, 128), jnp.int32),
        (words.reshape(nchunks, chunk), r.reshape(nchunks, chunk)),
    )
    return hist_f.reshape(num_rows, nbanks * 128)[:, : F + 1]


@partial(
    jax.jit,
    static_argnames=(
        "vocab_size", "F", "count_gr", "count_eq", "chunk",
        "few_drop", "bad_drop",
    ),
)
def _compute_thresholds_jax(
    words: jax.Array,
    vals: jax.Array,
    vocab_size: int,
    F: int,
    count_gr: int,
    count_eq: int,
    chunk: int = 1 << 20,
    few_drop: bool = False,
    bad_drop: bool = False,
) -> Tuple[jax.Array, jax.Array]:
    r_all = jnp.clip(jnp.floor(vals + 0.5).astype(jnp.int32), 0, F)
    hist = banked_hist(words, r_all, vocab_size + 1, F, chunk)[:vocab_size]
    hist = hist.at[:, 0].set(0)
    zeta, nnz_w = _zeta_from_hist(
        hist, count_gr, count_eq, jnp, few_drop=few_drop, bad_drop=bad_drop
    )
    return zeta.astype(jnp.float32), nnz_w.sum()


def compute_thresholds_jax(
    words: jax.Array,
    vals: jax.Array,
    vocab_size: int,
    avg_doc_sz: float,
    nz_docs: int,
    num_topics: int,
    hyper,
) -> Tuple[jax.Array, jax.Array]:
    """Device ζ computation. `words` may include padded entries with id ==
    vocab_size (their values are ignored via a spill histogram row)."""
    return _compute_thresholds_jax(
        words,
        vals,
        vocab_size,
        freq_bound(avg_doc_sz),
        hyper.count_gr(nz_docs, num_topics),
        hyper.count_eq(nz_docs, num_topics),
        few_drop=hyper.few_samples_threshold_drop,
        bad_drop=hyper.bad_threshold_drop,
    )
