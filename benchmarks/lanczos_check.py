"""Full-scale on-device eigensolver cross-check (a numerics tripwire):
run BOTH iterative solvers — restarted block Krylov-Schur and
thick-restart Lanczos, algorithmically independent — on the same
NYTimes-shape B·Bᵀ operator on a GPU, and compare the top-k spectra. The
CPU test backend computes every f32 product exactly, so it cannot catch a
product demoted to bf16 passes or TF32 on the card; this check can
(reference analog: Spectra as the mutual check of block-KS,
src/sparseMatrix.cpp:1161-1192).

Usage: python benchmarks/lanczos_check.py [--small]
"""

import os
import sys
import time

import numpy as np


def main():
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    import jax

    from isle_jax.config import HyperParams
    from isle_jax.corpus import Corpus
    from isle_jax.hybrid import hybrid_from_thresholds
    from isle_jax.linalg import block_ks_device, lanczos_device
    from isle_jax.matops import mat_gram_x
    from isle_jax.obs import card_line, device_record, enable_compilation_cache
    from isle_jax.sparse import DocSparse
    from isle_jax.thresholds import compute_thresholds_jax

    from bench import synth_corpus, NYT, SMALL

    print(f"device {device_record()} card {card_line()}", flush=True)
    enable_compilation_cache()
    shape = SMALL if "--small" in sys.argv else NYT
    V, D, NNZ, k = shape["vocab"], shape["docs"], shape["nnz"], shape["k"]
    d, w, c = synth_corpus(V, D, NNZ, 0)
    corpus = Corpus.from_entries(d, w, c, vocab_size=V, num_docs=D,
                                 sort_dedup=False)
    print(f"shape: {V} x {D}, nnz {corpus.nnz}, k {k}", flush=True)
    hp = HyperParams()

    A = DocSparse.from_corpus(corpus, chunk=1 << 21)
    zetas, _ = compute_thresholds_jax(
        A.d_word, A.d_val, V, corpus.avg_doc_sz, corpus.nz_docs, k, hp
    )
    B, _, _ = hybrid_from_thresholds(A, zetas, 1536 << 20, chunk=1 << 21)
    print(f"B: {B.num_docs} docs, {B.nnz} nnz, head {B.num_head}", flush=True)

    op = lambda B_, X: mat_gram_x(B_, X, 1 << 21)
    key = jax.random.PRNGKey(7)

    t0 = time.perf_counter()
    res_bks = block_ks_device(
        op, V, k, op_data=B, blk=hp.block_ks_block_size,
        tol=hp.block_ks_tolerance, max_restarts=hp.block_ks_max_iters,
        key=key,
    )
    t_bks = time.perf_counter() - t0
    print(f"block_ks: {t_bks:.1f}s wall, {res_bks.nconv}/{k} converged, "
          f"{res_bks.op_calls} op calls", flush=True)

    t0 = time.perf_counter()
    res_lz = lanczos_device(
        op, V, k, op_data=B, tol=hp.block_ks_tolerance,
        max_restarts=hp.block_ks_max_iters, key=jax.random.PRNGKey(8),
    )
    t_lz = time.perf_counter() - t0
    print(f"lanczos:  {t_lz:.1f}s wall, {res_lz.nconv}/{k} converged",
          flush=True)

    ev_b = np.sort(np.asarray(res_bks.evals))[::-1][:k]
    ev_l = np.sort(np.asarray(res_lz.evals))[::-1][:k]
    rel = np.abs(ev_b - ev_l) / np.maximum(np.abs(ev_b), 1e-30)
    print(f"top-5 block_ks evals: {ev_b[:5]}", flush=True)
    print(f"top-5 lanczos  evals: {ev_l[:5]}", flush=True)
    print(
        f"rel eigenvalue disagreement: max {rel.max():.3e} "
        f"median {np.median(rel):.3e}",
        flush=True,
    )
    # Subspace agreement via operator residuals on each other's vectors
    # is implied by each solver's own residual criterion; the eigenvalue
    # agreement is the cross-solver check.
    status = "OK" if rel.max() < 1e-3 else "DISAGREE"
    print(f"LANCZOS CROSS-CHECK {status} (tol 1e-3 on rel evals; solver "
          f"tol {hp.block_ks_tolerance})", flush=True)


if __name__ == "__main__":
    main()
