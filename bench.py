"""isle-jax benchmark: end-to-end train wall-clock on a synthetic corpus at
UCI NYTimes scale (the reference's primary workload, BASELINE.md), plus
MWU inference throughput over the same corpus.

Runs on one GPU and fails without one: a CPU run would time XLA's CPU
backend, which nobody deploys. Every result line names the device.

Prints ONE JSON line:
  {"metric": ..., "value": seconds, "unit": "s", "device": {...}, ...}

Usage:
  python bench.py              # NYTimes scale
  python bench.py --small      # 28k vocab x 40k docs, quick sanity run
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time

import numpy as np

NYT = dict(vocab=102_660, docs=300_000, nnz=48_000_000, k=100)
SMALL = dict(vocab=28_000, docs=40_000, nnz=3_000_000, k=20)
TINY = dict(vocab=2_000, docs=3_000, nnz=120_000, k=10)

# Measured 1-core reference wall-clock on the IDENTICAL corpus (the
# MKL-shim-built ISLETrain on a sandbox CPU core,
# parity/reports/timerLog_ref_nyt-syn.txt = this bench's shape and seed).
REF_1CORE_S = {"nytimes": 234.8}


def _zipf_ranks(u: np.ndarray, n: int) -> np.ndarray:
    """Inverse-CDF sampling of ranks 0..n-1 with P(r) ~ 1/(r+1) — the
    Zipf(alpha=1) word-frequency law real bag-of-words corpora follow."""
    return np.minimum(
        (np.exp(u * np.log(float(n))) - 1.0).astype(np.int64), n - 1
    )


def synth_corpus(vocab: int, docs: int, nnz: int, seed: int = 0):
    """Synthetic bag-of-words with a true Zipf(1) word marginal (matching
    the UCI NYTimes distribution the reference benchmarks on — a few
    thousand head words carry most tokens) and planted topic structure:
    each doc draws half its tokens from one of 64 word bands, Zipf-skewed
    within the band."""
    rng = np.random.default_rng(seed)
    # Zipf token draws collapse heavily under (doc, word) dedup; oversample
    # so the DISTINCT pair count (the matrix nnz) hits the target.
    raw = int(nnz * 1.30)
    d = rng.integers(0, docs, raw, dtype=np.int64)
    w = _zipf_ranks(rng.random(raw), vocab)
    # Planted structure: each doc prefers one of 64 word bands.
    band = (d % 64).astype(np.int64)
    use_band = rng.random(raw) < 0.5
    bsz = max(vocab // 64, 1)
    band_w = band * bsz + _zipf_ranks(rng.random(raw), bsz)
    w = np.where(use_band, band_w, w)
    key = d * vocab + w
    key = np.unique(key)
    d = (key // vocab).astype(np.int64)
    w = (key % vocab).astype(np.int64)
    c = rng.integers(1, 8, len(key), dtype=np.int64)
    return d, w, c


def unit_mass_corpus(corpus):
    """The corpus with each doc re-normalized to unit mass — the input
    MWU inference takes (drivers/ISLEInfer.cpp)."""
    import dataclasses

    vals = (
        corpus.counts.astype(np.float32)
        / np.repeat(corpus.doc_sums(), np.diff(corpus.offsets))
    ).astype(np.float32)
    return dataclasses.replace(corpus, vals=vals)


def run_pipeline(shape: dict, seed: int, repeats: int, out_dir: str) -> dict:
    from isle_jax.config import TrainConfig
    from isle_jax.corpus import Corpus
    from isle_jax.mwu import build_infer_batch, infer_all
    from isle_jax.obs import compile_log_top, enable_compile_log
    from isle_jax.trainer import Trainer

    enable_compile_log()
    d, w, c = synth_corpus(shape["vocab"], shape["docs"], shape["nnz"], seed)
    corpus = Corpus.from_entries(  # synth_corpus output is sorted, unique
        d, w, c, vocab_size=shape["vocab"], num_docs=shape["docs"],
        sort_dedup=False,
    )
    # Edge topics on, as the BASELINE primary config specifies
    # (NYTimes k=100 + edge topics max 2000).
    cfg = TrainConfig(
        num_topics=shape["k"], seed=seed,
        compute_edge_topics=True, max_edge_topics=2000,
    )

    def train_once():
        tr = Trainer(cfg, output_dir=out_dir, quiet=True)
        tr.corpus = corpus
        tr._post_ingest()
        t0 = time.perf_counter()
        tr.train()
        tr.train_edge_topics()
        return tr, time.perf_counter() - t0

    tr, cold_s = train_once()
    top_compiles = [(n, round(s, 2)) for n, s in compile_log_top(8)]
    warm = []
    for _ in range(repeats):
        tr, s = train_once()
        warm.append(dict(train_s=s, phases={
            label: wall for label, wall, _ in tr.timer.phases}))
    totals = [r["train_s"] for r in warm] or [cold_s]

    # MWU inference throughput over the full corpus. top_n=5: the
    # reference's inference CLI reports only the top-5 topics per doc
    # (drivers/ISLEInfer.cpp:100-111).
    model = tr.get_model()
    batch = build_infer_batch(unit_mass_corpus(corpus), model.sum(axis=1))
    t0 = time.perf_counter()
    infer_all(model, batch, iters=15, Lf=10.0, top_n=5)
    infer_cold = time.perf_counter() - t0
    infer_warms = []
    for _ in range(3):
        t0 = time.perf_counter()
        infer_all(model, batch, iters=15, Lf=10.0, top_n=5)
        infer_warms.append(time.perf_counter() - t0)
    infer_s = float(np.median(infer_warms))
    return dict(
        nnz=corpus.nnz,
        cold_s=cold_s,
        train_s=float(np.median(totals)),
        warm_runs=[r["train_s"] for r in warm],
        phases={k: float(np.median([r["phases"].get(k, 0.0) for r in warm]))
                for k in (warm[-1]["phases"] if warm else {})},
        svd_gflops=tr.op_counter.gflops(),
        top_compiles=top_compiles,
        infer_cold_s=infer_cold,
        infer_warms=infer_warms,
        infer_docs_per_s=corpus.num_docs / infer_s,
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--repeats", type=int, default=3,
                    help="warm train repeats after the cold run")
    args = ap.parse_args()
    shape = TINY if args.tiny else (SMALL if args.small else NYT)
    label = "tiny" if args.tiny else ("small" if args.small else "nytimes")

    from isle_jax.obs import card_line, device_record, enable_compilation_cache

    device = device_record()
    card = card_line()
    enable_compilation_cache()
    print(f"# device {device} card {card}", file=sys.stderr)
    with tempfile.TemporaryDirectory() as out_dir:
        res = run_pipeline(shape, 0, args.repeats, out_dir)
    emit = dict(
        metric=(f"e2e train wall-clock (median of {args.repeats} warm "
                f"repeats), synthetic {label} ({shape['vocab']} vocab x "
                f"{shape['docs']} docs, {res['nnz']} nnz, k={shape['k']})"),
        value=res["train_s"],
        unit="s",
        vs_ref_1core=(REF_1CORE_S[label] / res["train_s"]
                      if label in REF_1CORE_S else None),
        card=card,
        device=device,
        **{k: v for k, v in res.items() if k != "train_s"},
    )
    print(json.dumps(emit))


if __name__ == "__main__":
    main()
