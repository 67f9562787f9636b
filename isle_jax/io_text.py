"""Text model artifacts: sparse/dense model files, top-words reports, and
the sparse-model loader used by inference.

Formats match the reference exactly so models interoperate both ways:
  - sparse model (`M_hat_catch_sparse`): `<topic>\t<word>\t<weight>` lines,
    1-based ids, entries > 1e-8, topic-major order
    (src/denseMatrix.cpp:153-187).
  - dense model: one tab-separated row of vocab weights per topic
    (src/denseMatrix.cpp:124-151).
  - loader: parses `<topic> <word> <weight>` into a word-major
    (vocab, num_topics) array (src/infer.cpp:125-249).
  - top-words report (`TopWordsPerTopic_catch.txt`): tab-separated top
    words per topic (src/trainer.cpp:855-886).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from . import native


def write_sparse_model(path: str, model: np.ndarray, base: int = 1) -> None:
    """model: (vocab, num_topics)."""
    native.write_sparse_model(path, model, base=base)


def write_dense_model(path: str, model: np.ndarray) -> None:
    with open(path, "w") as f:
        for t in range(model.shape[1]):
            f.write("\t".join(f"{x:.8g}" for x in model[:, t]))
            f.write("\n")


def load_sparse_model(
    path: str, num_topics: int, vocab_size: int, base: int = 1
) -> np.ndarray:
    """Returns a (vocab, num_topics) float32 array (word-major rows)."""
    data = np.loadtxt(path, dtype=np.float64, ndmin=2)
    out = np.zeros((vocab_size, num_topics), np.float32)
    if data.size == 0:
        return out
    t = data[:, 0].astype(np.int64) - base
    w = data[:, 1].astype(np.int64) - base
    out[w, t] = data[:, 2].astype(np.float32)
    return out


def load_dense_model(path: str, num_topics: int, vocab_size: int) -> np.ndarray:
    data = np.loadtxt(path, dtype=np.float32, ndmin=2)
    assert data.shape == (num_topics, vocab_size), data.shape
    return data.T.copy()


def top_words_per_topic(
    model: np.ndarray, n: int
) -> List[List[Tuple[int, float]]]:
    """Top-n (word, weight) per topic, weight-descending
    (DenseMatrix::find_n_top_words, src/denseMatrix.cpp:93-107)."""
    out = []
    for t in range(model.shape[1]):
        col = model[:, t]
        idx = np.argsort(-col, kind="stable")[:n]
        out.append([(int(i), float(col[i])) for i in idx])
    return out


def write_top_words(
    path: str,
    model: np.ndarray,
    vocab_words: Sequence[str],
    n: int,
) -> None:
    tops = top_words_per_topic(model, n)
    with open(path, "w") as f:
        for t, top in enumerate(tops):
            f.write("\t".join(vocab_words[w] for w, _ in top))
            f.write("\n")


def write_top_topics(
    path: str,
    weights: np.ndarray,  # (num_docs, k)
    converged: np.ndarray,
    doc_begin: int = 1,
    top_n: int = 5,
) -> None:
    """Per-doc top topics above uniform mass, at most top_n, as
    `<doc>\t<topic>\t<weight>` with 1-based topic ids
    (drivers/ISLEInfer.cpp:100-111).

    Vectorized selection + native buffered writer: the per-doc Python
    loop wrote one f-string per line (minutes at 1M-doc blocks). The ordering is identical to the loop: doc ascending,
    then weight descending with ties to the lower topic id (the loop's
    stable argsort over an ascending nonzero index list)."""
    D, k = weights.shape
    uniform = np.float32(1.0 / k)
    w = np.asarray(weights, np.float32)
    sel = (w > uniform) & np.asarray(converged, bool)[:, None]
    dd, tt = np.nonzero(sel)
    vv = w[dd, tt]
    # lexsort: last key primary -> (doc asc, -weight, topic asc ties)
    order = np.lexsort((tt, -vv, dd))
    dd, tt, vv = dd[order], tt[order], vv[order]
    # rank within each doc run; keep the first top_n
    if len(dd):
        starts = np.flatnonzero(np.concatenate([[True], dd[1:] != dd[:-1]]))
        run_start = np.repeat(starts, np.diff(np.concatenate([starts, [len(dd)]])))
        rank = np.arange(len(dd)) - run_start
        keep = rank < top_n
        dd, tt, vv = dd[keep], tt[keep], vv[keep]
    native.write_float_triples(path, dd, tt, vv, base_a=doc_begin, base_b=1)


def write_edge_composition(path: str, selected_pairs: np.ndarray) -> None:
    """`<t1>\t<t2>\t<count>` lines (print_edge_topic_composition,
    src/trainer.cpp:1171-1199)."""
    with open(path, "w") as f:
        for a, b, c in selected_pairs:
            f.write(f"{a}\t{b}\t{c}\n")
