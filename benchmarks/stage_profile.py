"""Per-stage warm timing of the training pipeline's dominant primitives on
one GPU: the threshold histogram, the fused hybrid build, one Gram
operator application and the dense head GEMMs in isolation.

It reports times and achieved rates only. Roofline shares need a peaks
table keyed by `device_kind`, which belongs with the benchmark (see
ROADMAP.md §1). Runs only on a GPU; a CPU run would time XLA's CPU
backend.

Usage:
  python benchmarks/stage_profile.py [--nyt] [--reps N]
"""

import argparse
import os
import sys
import time

import numpy as np

ROWS = []


def t(label, fn, reps=2, work=None, unit=None):
    """Time fn warm (after one call); `work` = row count or FLOPs of the
    stage's dominant primitive, reported per second in `unit`."""
    import jax

    jax.block_until_ready(fn())
    t0 = time.perf_counter()
    for _ in range(reps):
        jax.block_until_ready(fn())
    dt = (time.perf_counter() - t0) / reps
    line = f"{label:38s} {dt * 1e3:9.2f} ms"
    if work is not None:
        scale = 1e9 if unit == "GFLOP/s" else 1e6
        line += f"  {work / dt / scale:10.1f} {unit}"
    print(line, flush=True)
    ROWS.append((label, dt))
    return dt


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nyt", action="store_true",
                    help="full NYTimes bench shape")
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args()

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    import jax
    import jax.numpy as jnp

    from bench import NYT, SMALL, synth_corpus
    from isle_jax.config import DeviceConfig, HyperParams
    from isle_jax.corpus import Corpus
    from isle_jax.hybrid import _head_dot, h_gram_x, hybrid_from_thresholds
    from isle_jax.obs import card_line, device_record, enable_compilation_cache
    from isle_jax.sparse import DocSparse
    from isle_jax.thresholds import compute_thresholds_jax

    print(f"device {device_record()} card {card_line()}", flush=True)
    enable_compilation_cache()
    shape = NYT if args.nyt else SMALL
    V, D, k = shape["vocab"], shape["docs"], shape["k"]
    reps = args.reps
    d, w, c = synth_corpus(V, D, shape["nnz"], 0)
    corpus = Corpus.from_entries(d, w, c, vocab_size=V, num_docs=D,
                                 sort_dedup=False)
    nnz = int(corpus.nnz)
    hp = HyperParams()
    print(f"nnz {nnz}, avg_doc_sz {corpus.avg_doc_sz}", flush=True)

    t("upload A (compact)", lambda: DocSparse.from_corpus(
        corpus, chunk=1 << 21).w_val, reps=1, work=nnz, unit="Mrows/s")
    A = DocSparse.from_corpus(corpus, chunk=1 << 21)
    t("thresholds", lambda: compute_thresholds_jax(
        A.d_word, A.d_val, V, corpus.avg_doc_sz, corpus.nz_docs, k, hp),
      reps=reps, work=nnz, unit="Mrows/s")
    zetas, _ = compute_thresholds_jax(
        A.d_word, A.d_val, V, corpus.avg_doc_sz, corpus.nz_docs, k, hp)
    head_bytes = DeviceConfig().dense_head_bytes
    t("hybrid build (fused thresh+copy)",
      lambda: hybrid_from_thresholds(A, zetas, head_bytes,
                                     chunk=1 << 21)[0].td_word,
      reps=reps, work=nnz, unit="Mrows/s")
    H, _, _ = hybrid_from_thresholds(A, zetas, head_bytes, chunk=1 << 21)
    del A, zetas
    print(f"B: {H.num_docs} docs, {H.nnz} nnz; head {H.num_head} rows "
          f"covers {H.head_nnz / H.nnz:.0%}", flush=True)
    X = jnp.asarray(
        np.random.default_rng(0).standard_normal((V, 128)).astype(np.float32))
    t("h_gram_x (one op)", lambda: h_gram_x(H, X, 1 << 21), reps=reps,
      work=2 * int(H.nnz - H.head_nnz), unit="Mrows/s")
    hd = H.head
    flops = 2 * 3 * 2 * hd.shape[0] * hd.shape[1] * 128  # bf16x3, both ways

    @jax.jit
    def head_gram(hd, X):
        y = _head_dot(hd, X[: hd.shape[0]], transpose=True)
        return _head_dot(hd, y, transpose=False)

    t("head gram GEMMs", lambda: head_gram(hd, X), reps=reps, work=flops,
      unit="GFLOP/s")

    print("\n| stage | ms |", flush=True)
    print("|---|---|", flush=True)
    for label, dt in ROWS:
        print(f"| {label} | {dt * 1e3:.2f} |", flush=True)


if __name__ == "__main__":
    main()
