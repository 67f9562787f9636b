"""UCI-PubMed-scale run of the out-of-core StreamedTrainer — the
BASELINE.md scale test: 8.2M docs x 141k vocab, ~730M nnz, k=100,
importance sampling at 10% (reference config per
drivers/sampleTrainInstances.h and BASELINE.md).

The corpus is synthetic (zero network egress here) with the same Zipf(1)
word marginal + planted band structure as bench.py, at PubMed's shape.
Host arrays are cached in the temp directory so interrupted runs (or
resume=True re-runs) skip the synthesis. Runs on one GPU.

Usage:
  python benchmarks/pubmed_scale.py
      [--scale N]   # 1/N shape for a smoke run (default 1 = full)
      [--fresh]     # ignore stage checkpoints
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np

PUBMED = dict(vocab=141_043, docs=8_200_000, nnz=730_000_000, k=100)
CACHE = os.path.join(tempfile.gettempdir(), "pubmed_cache_{tag}.npz")


def build_corpus(scale: int):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    from bench import synth_corpus
    from isle_jax.corpus import Corpus

    V = PUBMED["vocab"]
    D = PUBMED["docs"] // scale
    NNZ = PUBMED["nnz"] // scale
    tag = f"s{scale}"
    path = CACHE.format(tag=tag)
    if os.path.exists(path):
        t0 = time.perf_counter()
        z = np.load(path)
        rows, counts, offsets = z["rows"], z["counts"], z["offsets"]
        print(f"# cache load {time.perf_counter()-t0:.0f}s", flush=True)
    else:
        t0 = time.perf_counter()
        d, w, c = synth_corpus(V, D, NNZ, seed=0)
        print(f"# synth {time.perf_counter()-t0:.0f}s, nnz={len(d)}",
              flush=True)
        # bincount + cumsum (np.add.at is ~10M entries/s — minutes at 730M)
        offsets = np.zeros(D + 1, np.int64)
        np.cumsum(np.bincount(d, minlength=D), out=offsets[1:])
        rows = w.astype(np.int32)
        counts = c.astype(np.uint8)
        del d, w, c
        np.savez(path, rows=rows, counts=counts, offsets=offsets)
        print(f"# cached to {path}", flush=True)

    # Assemble the Corpus without materializing per-entry doc ids: the
    # normalization needs only per-doc sums (Corpus.from_entries semantics).
    nnz = int(offsets[-1])
    fcounts = counts.astype(np.float32)
    lengths = np.diff(offsets)
    doc_sums = np.add.reduceat(fcounts, np.minimum(offsets[:-1], nnz - 1))
    doc_sums[lengths == 0] = 0.0
    nz_docs = int((lengths > 0).sum())
    total = int(counts.astype(np.uint64).sum())
    avg = float(np.float32(total // max(nz_docs, 1)))
    per_entry = np.repeat(doc_sums.astype(np.float32), lengths)
    vals = (np.float32(avg) * (fcounts / per_entry)).astype(np.float32)
    del per_entry
    return Corpus(
        vocab_size=V, num_docs=D, offsets=offsets, rows=rows,
        counts=fcounts, vals=vals, avg_doc_sz=avg, nz_docs=nz_docs,
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=1)
    ap.add_argument("--fresh", action="store_true")
    ap.add_argument("--chunk-log2", type=int, default=25)
    ap.add_argument("--tag", default="",
                    help="run-dir suffix so A/B legs don't share "
                         "checkpoints")
    args = ap.parse_args()

    corpus = build_corpus(args.scale)
    print(
        f"# corpus: {corpus.vocab_size} x {corpus.num_docs}, "
        f"nnz {corpus.nnz}, avg_doc_sz {corpus.avg_doc_sz}",
        flush=True,
    )

    import jax

    from isle_jax.config import TrainConfig
    from isle_jax.obs import card_line, device_record, enable_compilation_cache
    from isle_jax.streaming import StreamedTrainer

    print(f"# device {device_record()} card {card_line()}", flush=True)
    enable_compilation_cache()
    cfg = TrainConfig(
        num_topics=PUBMED["k"],
        sample_docs=True,
        sample_rate=0.1,
        compute_edge_topics=True,  # BASELINE scale config: + edge topics
        max_edge_topics=2000,
        seed=0,
    )
    out = os.path.join(tempfile.gettempdir(),
                       f"isle_pubmed_s{args.scale}{args.tag}")
    tr = StreamedTrainer(
        cfg, output_dir=out, quiet=False, chunk_entries=1 << args.chunk_log2
    )
    tr._t.corpus = corpus  # attribute writes don't delegate through the wrapper
    tr._post_ingest()

    t0 = time.perf_counter()
    tr.train(resume=not args.fresh)
    tr.train_edge_topics()
    train_s = time.perf_counter() - t0
    for label, wall, cpu in tr.timer.phases:
        print(f"#   phase {label}: {wall:.2f}s", flush=True)
    print(f"# train_s: {train_s:.1f}", flush=True)
    loader = getattr(tr, "_loader", None)
    if loader is not None and hasattr(loader, "fill_seconds"):
        print(
            f"# resident corpus: {loader.fill_count} fill(s), "
            f"{loader.fill_seconds:.1f}s encode+dispatch total",
            flush=True,
        )
    stats = jax.local_devices()[0].memory_stats()
    print(f"# peak device memory: "
          f"{stats.get('peak_bytes_in_use', 0) / 2**30:.2f} GiB", flush=True)
    ncw = sum(len(c) for c in tr.catchwords)
    print(
        f"# model nnz: {(tr.model > 0).sum()}  catchwords: {ncw}  "
        f"run dir: {tr.run_dir}",
        flush=True,
    )


if __name__ == "__main__":
    main()
