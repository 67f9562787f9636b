"""Smoke run on NVIDIA GPUs: the main path through the entry points a user
calls, at the NYTimes shape (102,660 vocab x 300,000 docs, ~48M nnz,
k=100, edge topics), with every output checked against the repo's plain
references. Random corpora are generated from seeds.

    python chip_smoke.py            # one card: phases 0-5
    python chip_smoke.py --multi    # four cards: the doc-sharded mesh path

Phases on one card; any failure exits non-zero:
  0  device: JAX must see GPUs (no CPU fallback); prints the card.
  1  CLI: isle_jax.cli.train (edge topics) then isle_jax.cli.infer, in
     this process, at the SMALL shape; the written files must parse.
  2  main path at the NYT shape: Trainer.train() + train_edge_topics()
     cold and warm; eigen residuals, model, catchwords; MWU inference
     over the corpus, a 2,000-doc slice against the literal oracle.
  3  hot operators against the plain COO references at real widths
     (f32 at Precision.HIGHEST: a TF32 product would fail the bounds).
  4  StreamedTrainer over >= 4 chunks against the in-core Trainer.
  5  the card-only tests (`pytest -m gpu`).

The last line of standard output is one JSON object:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import jax
import jax.numpy as jnp

from bench import NYT, SMALL, synth_corpus, unit_mass_corpus
from isle_jax.config import DeviceConfig, TrainConfig
from isle_jax.corpus import Corpus
from isle_jax.obs import card_line, device_record, enable_compilation_cache

REPO = os.path.dirname(os.path.abspath(__file__))
# Operator bound: f32 sums taken in another order. A head word's B Y row
# sums up to 3e5 terms; sequential f32 accumulation (scatter atomics)
# leaves ~eps*sqrt(n/2) ~ 2e-5 relative noise there (6.2e-5 measured
# between the two f32 operators at the NYT shape), while a TF32 product
# reads ~1e-3.
OP_TOL = 1e-4
DIST_TOL = 1e-5  # Lloyd's distances: short dense sums, no long accumulation
RESID_TOL = 1e-3  # recomputed eigen residual: solver tol 1e-4 + operator noise
MWU_TOL = 1e-4  # per-doc relative error of the MWU weights
# Two training runs over one corpus: sums run in another order (GPU
# scatters are atomics, so even the same code differs run to run), and
# k-means++ seeding and Lloyd's turn last-bit differences into other
# cluster labels and partly other clusters. So models are compared by
# eigenvalues (continuous, before any discrete step) and by label-free
# topic matching, not elementwise (the CPU's atol=2e-3 reads 3.5e-3 to
# 6.6e-3 on the card). A broken path matches far fewer topics.
EVAL_RTOL = 1e-4
MATCH_COS = 0.9  # a topic "matches" when some topic of the other model
MATCH_MIN = 0.5  # is this close; gate on this fraction of matched topics


def result_line(device: dict) -> str:
    """The final stdout line: exactly {"ok": true, "device": {...}}."""
    return json.dumps({"ok": True, "device": {
        "platform": device["platform"], "kind": device["kind"],
        "count": device["count"]}})


def rel_fro(got, ref) -> float:
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


class Smoke:
    def __init__(self, card: str):
        self.card = card

    def say(self, msg: str) -> None:
        print(msg, flush=True)

    def timed(self, label: str, seconds: float) -> None:
        self.say(f"{label}: {seconds:.3f} s [{self.card}]")

    def check(self, ok: bool, what: str) -> None:
        if not ok:
            raise AssertionError(what)
        self.say(f"  ok: {what}")


def make_corpus(s: "Smoke", shape: dict, seed: int = 0) -> Corpus:
    t0 = time.perf_counter()
    d, w, c = synth_corpus(shape["vocab"], shape["docs"], shape["nnz"], seed)
    # synth_corpus emits (doc, word)-sorted unique entries
    corpus = Corpus.from_entries(d, w, c, vocab_size=shape["vocab"],
                                 num_docs=shape["docs"], sort_dedup=False)
    s.timed(f"  corpus set-up ({corpus.nnz} nnz, host)",
            time.perf_counter() - t0)
    return corpus


def train(cfg: TrainConfig, corpus: Corpus, out_dir: str, edge: bool):
    from isle_jax.trainer import Trainer

    tr = Trainer(cfg, output_dir=out_dir, quiet=True)
    tr.corpus = corpus
    tr._post_ingest()
    t0 = time.perf_counter()
    tr.train()
    if edge:
        tr.train_edge_topics()
    return tr, time.perf_counter() - t0


def check_model(s: Smoke, model: np.ndarray, name: str) -> None:
    s.check(bool(np.isfinite(model).all()), f"{name} model is finite")
    dev = float(np.abs(model.sum(axis=0) - 1.0).max())
    s.check(dev < 1e-4, f"{name} model columns sum to 1 (max dev {dev:.2e})")


def compare_models(s: "Smoke", a, b, what: str, gated: bool = True) -> None:
    """Compare two trained models of one corpus (Trainer-like objects):
    eigenvalues, the fraction of a's topics with a counterpart in b at
    cosine >= MATCH_COS, and (printed only) the elementwise difference."""
    ev = float(np.max(np.abs(b.evalues - a.evalues) / np.abs(a.evalues)))
    na = a.model / np.linalg.norm(a.model, axis=0)
    nb = b.model / np.linalg.norm(b.model, axis=0)
    match = float(np.mean((na.T @ nb).max(axis=1) >= MATCH_COS))
    diff = float(np.abs(a.model - b.model).max())
    s.say(f"  {what}: eigenvalues max rel diff {ev:.2e}, {match:.3f} of "
          f"topics matched at cosine >= {MATCH_COS}, model max abs diff "
          f"{diff:.2e}")
    if gated:
        s.check(ev <= EVAL_RTOL and match >= MATCH_MIN,
                f"{what}: eigenvalues within {EVAL_RTOL}, matched topics "
                f">= {MATCH_MIN}")


def eigen_residuals(B, U, evals) -> np.ndarray:
    """||B B^T u_j - lambda_j u_j|| / lambda_j per pair, recomputed with the
    operator the solver used (matops.mat_gram_x)."""
    from isle_jax.matops import mat_gram_x

    R = np.asarray(mat_gram_x(B, jnp.asarray(U)), np.float64)
    R -= np.asarray(U, np.float64) * np.asarray(evals, np.float64)[None, :]
    return np.linalg.norm(R, axis=0) / np.abs(np.asarray(evals, np.float64))


def operator_errors(Bh, Bc, seed: int = 0, width: int = 128) -> dict:
    """Relative Frobenius error of each hybrid operator against its plain
    COO reference on random (V, width) / (D, width) operands."""
    from isle_jax.hybrid import h_b_y, h_bt_x, h_gram_x
    from isle_jax.sparse import b_y, bt_x, gram_x

    kx, ky = jax.random.split(jax.random.PRNGKey(seed))
    X = jax.random.normal(kx, (Bc.vocab, width), jnp.float32)
    Y = jax.random.normal(ky, (Bc.num_docs, width), jnp.float32)
    return {
        "gram_x": rel_fro(h_gram_x(Bh, X), gram_x(Bc, X)),
        "bt_x": rel_fro(h_bt_x(Bh, X), bt_x(Bc, X)),
        "b_y": rel_fro(h_b_y(Bh, Y), b_y(Bc, Y)),
    }


def lloyd_distance_error(P, centers) -> float:
    """One Lloyd's distance step (kmeans.projected_sq_dists) against numpy
    float64."""
    from isle_jax.kmeans import projected_sq_dists

    got = projected_sq_dists(P, centers)
    P64 = np.asarray(P, np.float64)
    C64 = np.asarray(centers, np.float64)
    ref = ((P64 * P64).sum(axis=0)[:, None] + (C64 * C64).sum(axis=1)[None, :]
           - 2.0 * P64.T @ C64.T)
    return rel_fro(got, ref)


def mwu_slice_error(model, batch, docs: np.ndarray, iters: int, Lf: float):
    """Max per-doc relative error of infer_all's weights against the
    literal MWU oracle (numpy) on `docs`, and whether converged flags agree."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from literal_oracle import mwu_literal
    from isle_jax.mwu import InferBatch, infer_all

    V, k = model.shape
    sub = InferBatch(
        word_idx=batch.word_idx[docs], a=batch.a[docs],
        words_in_doc=batch.words_in_doc[docs], num_docs=len(docs),
        avg_doc_sz=batch.avg_doc_sz,
        counts=None if batch.counts is None else batch.counts[docs],
        doc_sums=None if batch.doc_sums is None else batch.doc_sums[docs],
    )
    w_dev, conv_dev, _, _ = infer_all(model, sub, iters=iters, Lf=Lf)
    worst, flags_agree = 0.0, True
    for i in range(len(docs)):
        keep = sub.word_idx[i] < V
        w_ref, conv_ref = mwu_literal(sub.a[i][keep], model[sub.word_idx[i][keep]],
                                      k, iters, Lf)
        flags_agree &= bool(conv_ref) == bool(conv_dev[i])
        if conv_ref:
            worst = max(worst, float(np.linalg.norm(w_dev[i] - w_ref)
                                     / np.linalg.norm(w_ref)))
    return worst, flags_agree


def phase0() -> tuple:
    device = device_record()
    card = card_line()
    limit = jax.devices()[0].memory_stats()["bytes_limit"]
    print(f"phase 0 device: {device['count']} x {device['kind']}, "
          f"bytes_limit {limit}, card {card}", flush=True)
    print(f"compilation cache: {enable_compilation_cache()}", flush=True)
    return device, card


def phase1_cli(s: Smoke, work: str, shape: dict) -> None:
    from isle_jax import native
    from isle_jax.cli import infer as cli_infer, train as cli_train
    from isle_jax.io_text import load_sparse_model

    s.say("phase 1: CLI train (edge topics) + infer")
    d, w, c = synth_corpus(shape["vocab"], shape["docs"], shape["nnz"], 1)
    tdf = os.path.join(work, "small.tdf")
    native.write_int_triples(tdf, d, w, c, base_a=1, base_b=1, base_c=0)
    vocab = os.path.join(work, "vocab.txt")
    with open(vocab, "w") as f:
        f.write("".join(f"w{i}\n" for i in range(shape["vocab"])))
    out = os.path.join(work, "cli")
    k = shape["k"]
    t0 = time.perf_counter()
    rc = cli_train.main([tdf, vocab, out, str(shape["vocab"]),
                         str(shape["docs"]), str(len(d)), str(k),
                         "0", "0", "0", "1", "50"])
    s.timed("  cli train", time.perf_counter() - t0)
    s.check(rc == 0, "cli train exit 0")
    (run_dir,) = [os.path.join(out, x) for x in os.listdir(out)]
    model_f = os.path.join(run_dir, "M_hat_catch_sparse")
    edge_f = os.path.join(run_dir, "EdgeModel_sparse")
    model = load_sparse_model(model_f, k, shape["vocab"])
    check_model(s, model, "cli")
    edge = np.loadtxt(edge_f, ndmin=2)
    s.check(edge.shape[0] > 0 and edge.shape[1] == 3,
            f"edge model parses ({edge.shape[0]} entries)")
    inf_out = os.path.join(work, "infer")
    t0 = time.perf_counter()
    rc = cli_infer.main([model_f, tdf, inf_out, str(k), str(shape["vocab"]),
                         "1", str(shape["docs"] + 1), str(len(d)),
                         "0", "0", "0"])
    s.timed("  cli infer", time.perf_counter() - t0)
    s.check(rc == 0, "cli infer exit 0")
    tops = [x for x in os.listdir(inf_out) if x.startswith("top_topics")]
    s.check(len(tops) == 1, f"inference output written ({tops})")
    rows = np.loadtxt(os.path.join(inf_out, tops[0]), ndmin=2)
    s.check(rows.shape[0] > 0 and np.isfinite(rows).all(),
            f"inference output parses ({rows.shape[0]} lines)")


def phase2_main(s: Smoke, work: str, corpus: Corpus, k: int):
    s.say(f"phase 2: NYT main path ({corpus.vocab_size} vocab x "
          f"{corpus.num_docs} docs, {corpus.nnz} nnz, k={k})")
    cfg = TrainConfig(num_topics=k, seed=0, compute_edge_topics=True,
                      max_edge_topics=2000)
    runs = []
    for tag in ("cold", "warm"):
        tr, secs = train(cfg, corpus, os.path.join(work, "nyt"), edge=True)
        s.timed(f"  {tag} Trainer.train + train_edge_topics", secs)
        for label, wall, _ in tr.timer.phases:
            s.timed(f"    {tag} {label}", wall)
        runs.append(tr)
    s.say(f"  {tr.op_counter.summary()} [{s.card}]")
    compare_models(s, runs[0], runs[1], "cold vs warm run (same code)",
                   gated=False)
    check_model(s, tr.model, "NYT")
    s.check(tr.edge_model is not None and tr.edge_model.shape[1] > 0,
            f"edge topics built ({tr.edge_model.shape[1]})")
    per_topic = [len(c) for c in tr.catchwords]
    s.say(f"  catchwords per topic: {per_topic}")
    s.check(sum(per_topic) > 0, f"catchwords found ({sum(per_topic)} total)")

    # MWU inference over the whole corpus, then the oracle on a slice.
    from isle_jax.mwu import build_infer_batch, infer_all

    batch = build_infer_batch(unit_mass_corpus(corpus), tr.model.sum(axis=1))
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        _, conv, _, _ = infer_all(tr.model, batch, iters=15, Lf=10.0, top_n=5)
        times.append(time.perf_counter() - t0)
    s.timed("  MWU infer_all cold", times[0])
    s.timed("  MWU infer_all warm", min(times[1:]))
    s.say(f"  MWU {corpus.num_docs / min(times[1:]):.0f} docs/s warm, "
          f"{int(conv.sum())}/{corpus.num_docs} converged [{s.card}]")
    docs = np.arange(2000)
    err, flags = mwu_slice_error(tr.model, batch, docs, 15, 10.0)
    s.check(flags, "MWU converged flags match the literal oracle (2,000 docs)")
    s.check(err <= MWU_TOL, f"MWU weights match the literal oracle "
            f"(max per-doc rel err {err:.2e} <= {MWU_TOL})")
    return tr


def phase3_operators(s: Smoke, corpus: Corpus, tr) -> None:
    from isle_jax.bmatrix import threshold_and_copy
    from isle_jax.hybrid import hybrid_from_thresholds
    from isle_jax.sparse import DocSparse, bt_x

    s.say("phase 3: operators against plain references (f32 HIGHEST)")
    ck = np.load(os.path.join(tr.run_dir, "ckpt_svd.npz"))
    zetas = jnp.asarray(ck["zetas"])
    cfg = tr.config.device
    A = DocSparse.from_corpus(corpus, chunk=cfg.spmm_chunk)
    Bc, cols_c = threshold_and_copy(A, zetas, chunk=cfg.spmm_chunk)
    Bh, cols_h, _ = hybrid_from_thresholds(A, zetas, cfg.dense_head_bytes,
                                           chunk=cfg.spmm_chunk)
    del A
    s.check(np.array_equal(np.asarray(cols_c), np.asarray(cols_h)),
            f"hybrid and COO B keep the same {Bc.num_docs} docs")
    from isle_jax.hybrid import h_gram_x

    ma = h_gram_x.lower(Bh, jnp.zeros((Bh.vocab, 128), jnp.float32)).compile(
    ).memory_analysis()
    s.say(f"  h_gram_x temp bytes {ma.temp_size_in_bytes} beside a "
          f"{Bh.head.size * Bh.head.dtype.itemsize}-byte bf16 head")
    for name, err in operator_errors(Bh, Bc).items():
        s.check(err <= OP_TOL, f"hybrid h_{name} vs COO {name} at width 128: "
                f"rel Frobenius {err:.2e} <= {OP_TOL} "
                f"(head {Bh.num_head} rows)")
    s.check(tr.eigen_nconv == len(ck["evalues"]),
            f"the solver converged {tr.eigen_nconv}/{len(ck['evalues'])} "
            f"pairs at relative residual < 1e-4 (its own criterion)")
    res = eigen_residuals(Bh, ck["U"], ck["evalues"])
    s.check(bool((res < RESID_TOL).all()), f"recomputed eigen residuals "
            f"< {RESID_TOL} (max {res.max():.2e} at pair "
            f"{int(res.argmax())}, median {np.median(res):.2e})")
    P = bt_x(Bc, jnp.asarray(ck["U"])).T  # (k, D_B)
    idx = np.random.default_rng(0).choice(Bc.num_docs, P.shape[0], replace=False)
    centers = P[:, idx].T
    err = lloyd_distance_error(P, centers)
    s.check(err <= DIST_TOL, f"Lloyd's distance step vs numpy float64: "
            f"rel Frobenius {err:.2e} <= {DIST_TOL}")


def phase4_streamed(s: Smoke, work: str, corpus: Corpus, k: int) -> None:
    from isle_jax.streaming import StreamedTrainer, doc_chunks

    s.say("phase 4: StreamedTrainer vs in-core Trainer")
    ce = 1 << int(np.log2(corpus.nnz / 4))  # at least 4 chunks
    n_chunks = len(list(doc_chunks(corpus, ce)))
    s.check(n_chunks >= 4, f"corpus streams in {n_chunks} chunks")
    cfg = TrainConfig(num_topics=k, seed=0)
    tr, secs = train(cfg, corpus, os.path.join(work, "incore"), edge=False)
    s.timed("  in-core train (SMALL)", secs)
    ts = StreamedTrainer(cfg, output_dir=os.path.join(work, "streamed"),
                         chunk_entries=ce)
    ts._t.corpus = corpus
    ts._t._post_ingest()
    t0 = time.perf_counter()
    ts.train()
    s.timed("  streamed train (SMALL)", time.perf_counter() - t0)
    check_model(s, ts.model, "streamed")
    compare_models(s, tr, ts, "streamed vs in-core")


def phase5_gpu_tests(s: Smoke) -> None:
    import pytest

    s.say("phase 5: card-only tests (pytest -m gpu)")
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(REPO, "tests", "test_gpu_numerics.py")])
    s.check(rc == 0, f"pytest -m gpu exit {int(rc)}")


def run_one_card(s: Smoke, nyt: dict = NYT, small: dict = SMALL) -> None:
    with tempfile.TemporaryDirectory() as work:
        phase1_cli(s, work, small)
        corpus = make_corpus(s, nyt)
        tr = phase2_main(s, work, corpus, nyt["k"])
        phase3_operators(s, corpus, tr)
        del tr, corpus
        phase4_streamed(s, work, make_corpus(s, small), small["k"])
    phase5_gpu_tests(s)


def run_multi(s: Smoke, n: int, nyt: dict = NYT, small: dict = SMALL) -> None:
    """The doc-sharded mesh path (DeviceConfig(mesh_shape=(n,))) against
    one-card runs of the same corpora in this process."""
    from isle_jax.mwu import build_infer_batch, infer_all
    from isle_jax.sharding import make_mesh
    from isle_jax.streaming import StreamedTrainer

    s.check(len(jax.devices()) >= n, f"{len(jax.devices())} devices >= {n}")
    mesh_dev = DeviceConfig(mesh_shape=(n,))
    with tempfile.TemporaryDirectory() as work:
        corpus = make_corpus(s, nyt)
        cfg1 = TrainConfig(num_topics=nyt["k"], seed=0)
        cfgn = TrainConfig(num_topics=nyt["k"], seed=0, device=mesh_dev)
        runs = {}
        for name, cfg in (("1 card", cfg1), (f"{n}-card mesh", cfgn)):
            for tag in ("cold", "warm"):
                tr, secs = train(cfg, corpus, os.path.join(work, name), False)
                s.timed(f"  {name} NYT train {tag}", secs)
            runs[name] = tr
        t1, tn = runs["1 card"], runs[f"{n}-card mesh"]
        check_model(s, tn.model, "mesh")
        ev = float(np.max(np.abs(tn.evalues - t1.evalues)
                          / np.abs(t1.evalues)))
        s.check(ev <= EVAL_RTOL, f"mesh eigenvalues match one card (max rel "
                f"{ev:.2e})")
        compare_models(s, t1, tn, "mesh vs one card", gated=False)

        batch = build_infer_batch(unit_mass_corpus(corpus),
                                  t1.model.sum(axis=1))
        w1, c1, _, _ = infer_all(t1.model, batch, iters=15, Lf=10.0, top_n=5)
        mesh = make_mesh(n)
        for tag in ("cold", "warm"):
            t0 = time.perf_counter()
            wn, cn, _, _ = infer_all(t1.model, batch, iters=15, Lf=10.0,
                                     top_n=5, mesh=mesh)
            s.timed(f"  sharded infer_all {tag}", time.perf_counter() - t0)
        s.check(bool((c1 == cn).all()), "sharded MWU converged flags match")
        err = float(np.abs(wn - w1).max())
        s.check(err <= 1e-5, f"sharded MWU weights match one card "
                f"(max abs diff {err:.2e})")
        del corpus, runs, t1, tn

        sm = make_corpus(s, small)
        cfg1 = TrainConfig(num_topics=small["k"], seed=0)
        ref, _ = train(cfg1, sm, os.path.join(work, "sm1"), False)
        ts = StreamedTrainer(
            TrainConfig(num_topics=small["k"], seed=0, device=mesh_dev),
            output_dir=os.path.join(work, "smn"), chunk_entries=1 << 18)
        ts._t.corpus = sm
        ts._t._post_ingest()
        t0 = time.perf_counter()
        ts.train()
        s.timed("  streamed x mesh train (SMALL)", time.perf_counter() - t0)
        check_model(s, ts.model, "streamed x mesh")
        compare_models(s, ref, ts, "streamed x mesh vs one card")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card doc-sharded mesh path")
    args = ap.parse_args(argv)
    device, card = phase0()
    s = Smoke(card)
    t0 = time.perf_counter()
    if args.multi:
        run_multi(s, 4)
    else:
        run_one_card(s)
    s.timed("total", time.perf_counter() - t0)
    s.say(f"card: {card}")
    print(result_line(device), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
