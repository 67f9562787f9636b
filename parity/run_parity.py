#!/usr/bin/env python3
"""Reference-vs-rebuild parity comparator (see parity/README.md).

    python parity/run_parity.py --dataset kos \
        [--ref-bin parity/bin] [--data-dir parity/data] [--out DIR]

Per dataset it trains both implementations with the same 12-arg CLI
contract, compares the deterministic training invariants, cross-runs MWU
inference on both model files at 1e-4, and writes a parity report. Every
missing prerequisite is a clean SKIP (exit 0), so this can sit in CI
until egress + a reference build exist.

Configs follow BASELINE.md's parity rows (KOS k=10 no sampling, NIPS
k=50), contract per /root/reference/drivers/ISLETrain.cpp:9-32 and
ISLEInfer.cpp:10-36.
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import re
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, HERE)
sys.path.insert(0, REPO)

CONFIGS = {
    "kos": dict(k=10, sample=0, rate=0.0, edge=1, max_edge=100),
    "nips": dict(k=50, sample=0, rate=0.0, edge=1, max_edge=100),
    "enron": dict(k=100, sample=0, rate=0.0, edge=1, max_edge=1000),
    "nytimes": dict(k=100, sample=0, rate=0.0, edge=1, max_edge=2000),
    # Synthetic stand-ins (UCI egress is blocked here): deterministic
    # Zipf(1)+planted-band corpora from parity/synth_data.py at KOS/NIPS
    # scale. k matches the synthetic generator's declared k.
    "tiny-syn": dict(k=5, sample=0, rate=0.0, edge=1, max_edge=20),
    "kos-syn": dict(k=10, sample=0, rate=0.0, edge=1, max_edge=100),
    "nips-syn": dict(k=50, sample=0, rate=0.0, edge=1, max_edge=100),
    # bench.py's exact shapes + seed (see parity/synth_data.py): the
    # reference binary on the very corpus the benchmark measures.
    "small-syn": dict(k=20, sample=0, rate=0.0, edge=1, max_edge=100),
    "nyt-syn": dict(k=100, sample=0, rate=0.0, edge=1, max_edge=2000),
}
TOL = 1e-4


def prep_tdf(data_dir: str, name: str, out_dir: str):
    """UCI docword.gz (or synthetic) -> TDF + (docs, vocab, nnz)."""
    if name.endswith("-syn"):
        from synth_data import write_dataset
        tdf = os.path.join(data_dir, f"{name}.tdf")
        vocab_f = os.path.join(data_dir, f"vocab.{name}.txt")
        if not (os.path.exists(tdf) and os.path.exists(vocab_f)):
            meta = write_dataset(name, data_dir)
        else:
            from synth_data import SHAPES
            import numpy as np
            body = np.loadtxt(tdf, dtype=int)
            meta = dict(vocab=SHAPES[name]["vocab"],
                        docs=int(body[:, 0].max()), nnz=len(body))
        return tdf, vocab_f, meta["docs"], meta["vocab"], meta["nnz"]
    gz = os.path.join(data_dir, f"docword.{name}.txt.gz")
    vocab_f = os.path.join(data_dir, f"vocab.{name}.txt")
    if not (os.path.exists(gz) and os.path.exists(vocab_f)):
        return None
    tdf = os.path.join(out_dir, f"{name}.tdf")
    with gzip.open(gz, "rt") as f:
        docs = int(next(f))
        vocab = int(next(f))
        nnz = int(next(f))
        if not os.path.exists(tdf):
            with open(tdf, "w") as o:
                for line in f:
                    o.write(line)
    return tdf, vocab_f, docs, vocab, nnz


def run(cmd, log_path, env=None):
    print("+", " ".join(map(str, cmd)))
    full_env = dict(os.environ)
    if env:
        full_env.update(env)
    with open(log_path, "w") as log:
        p = subprocess.run(list(map(str, cmd)), stdout=log,
                           stderr=subprocess.STDOUT, env=full_env)
    return p.returncode


def grep1(path, pattern):
    with open(path, errors="replace") as f:
        for line in f:
            m = re.search(pattern, line)
            if m:
                return m.group(1)
    return None


def load_top_topics(run_dir):
    """Parse every top_topics_* file into {(doc, topic): wt}."""
    out = {}
    for fn in sorted(os.listdir(run_dir)):
        if not fn.startswith("top_topics"):
            continue
        with open(os.path.join(run_dir, fn)) as f:
            for line in f:
                parts = line.split()
                if len(parts) == 3:
                    out[(int(parts[0]), int(parts[1]))] = float(parts[2])
    return out


def compare_inference(dir_a, dir_b, label, report):
    wa = load_top_topics(dir_a)
    wb = load_top_topics(dir_b)
    if not wa or not wb:
        report[label] = "SKIP: missing top-topics output"
        return
    common = set(wa) & set(wb)
    max_rel = 0.0
    for key in common:
        denom = max(abs(wa[key]), abs(wb[key]), 1e-12)
        max_rel = max(max_rel, abs(wa[key] - wb[key]) / denom)
    jaccard = len(common) / max(len(set(wa) | set(wb)), 1)
    ok = max_rel <= TOL and jaccard > 0.99
    report[label] = dict(
        ok=bool(ok), max_rel_err=max_rel, pair_jaccard=jaccard,
        pairs=len(common),
    )


def model_nnz(path):
    n = 0
    with open(path) as f:
        for _ in f:
            n += 1
    return n


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="kos", choices=sorted(CONFIGS))
    ap.add_argument("--ref-bin", default=os.path.join(HERE, "bin"))
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--platform", default="cpu",
                    help="JAX_PLATFORMS for the rebuild legs (default cpu, "
                         "the backend the reference's numbers compare to)")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "isle_parity"))
    args = ap.parse_args()
    name = args.dataset
    if args.data_dir is None:
        args.data_dir = os.path.join(
            HERE, "data_syn" if name.endswith("-syn") else "data")
    cfgd = CONFIGS[name]
    args.out = os.path.join(args.out, name)
    os.makedirs(args.out, exist_ok=True)

    prep = prep_tdf(args.data_dir, name, args.out)
    if prep is None:
        print(f"SKIP: UCI data for {name!r} not in {args.data_dir} "
              f"(run parity/fetch_uci.py)")
        return 0
    tdf, vocab_f, docs, vocab, nnz = prep
    ref_train = os.path.join(args.ref_bin, "ISLETrain")
    ref_infer = os.path.join(args.ref_bin, "ISLEInfer")
    have_ref = os.path.exists(ref_train) and os.path.exists(ref_infer)
    if not have_ref:
        print(f"SKIP(reference): {ref_train} missing "
              f"(run parity/build_reference.sh); training rebuild only")

    report = dict(dataset=name, docs=docs, vocab=vocab, nnz=nnz)
    k = cfgd["k"]
    train_args = [tdf, vocab_f, None, vocab, docs, nnz, k, 0,
                  cfgd["sample"], cfgd["rate"], cfgd["edge"],
                  cfgd["max_edge"]]

    # --- train ours ---
    ours_dir = os.path.join(args.out, "ours")
    os.makedirs(ours_dir, exist_ok=True)
    train_args[2] = ours_dir
    ours_env = {"JAX_PLATFORMS": args.platform, "PYTHONPATH": ":".join(
        p for p in [REPO, os.environ.get("PYTHONPATH", "")] if p)}
    rc = run([sys.executable, "-m", "isle_jax.cli.train", *train_args],
             os.path.join(args.out, "ours_train.log"), env=ours_env)
    assert rc == 0, "rebuild training failed"

    # --- train reference ---
    ref_dir = os.path.join(args.out, "ref")
    if have_ref:
        os.makedirs(ref_dir, exist_ok=True)
        train_args[2] = ref_dir
        rc = run([ref_train, *train_args],
                 os.path.join(args.out, "ref_train.log"))
        assert rc == 0, "reference training failed"

        # deterministic training invariants (seed-independent)
        for label, pat in [
            ("entries_above_threshold", r"ntries above threshold[^0-9]*([0-9]+)"),
            ("columns_remaining", r"olumns remaining[^0-9]*([0-9]+)"),
        ]:
            a = grep1(os.path.join(args.out, "ours_train.log"), pat)
            b = grep1(os.path.join(args.out, "ref_train.log"), pat)
            report[label] = dict(ours=a, ref=b,
                                 ok=(a is not None and a == b))

    # locate model files (both write M_hat_catch_sparse under a
    # config-encoded run dir)
    def find_model(base):
        for root, _, files in os.walk(base):
            if "M_hat_catch_sparse" in files:
                return os.path.join(root, "M_hat_catch_sparse")
        return None

    m_ours = find_model(ours_dir)
    report["model_ours"] = m_ours
    assert m_ours, "rebuild produced no model file"

    # --- cross-inference at 1e-4: both engines on each model file ---
    if have_ref:
        m_ref = find_model(ref_dir)
        report["model_ref"] = m_ref
        for tag, model in [("oursmodel", m_ours), ("refmodel", m_ref)]:
            ia = os.path.join(args.out, f"inf_ours_{tag}")
            ib = os.path.join(args.out, f"inf_ref_{tag}")
            os.makedirs(ia, exist_ok=True)
            os.makedirs(ib, exist_ok=True)
            inf_args = [model, tdf, None, k, vocab, 1, docs + 1, nnz,
                        model_nnz(model), 0, 0]
            inf_args[2] = ia
            run([sys.executable, "-m", "isle_jax.cli.infer", *inf_args],
                os.path.join(args.out, f"inf_ours_{tag}.log"), env=ours_env)
            inf_args[2] = ib
            run([ref_infer, *inf_args],
                os.path.join(args.out, f"inf_ref_{tag}.log"))
            compare_inference(ia, ib, f"mwu_parity_{tag}", report)

    rpath = os.path.join(args.out, f"parity_{name}.json")
    with open(rpath, "w") as f:
        json.dump(report, f, indent=1, default=str)
    print(json.dumps(report, indent=1, default=str))
    print(f"report: {rpath}")
    checks = [v for v in report.values()
              if isinstance(v, dict) and "ok" in v]
    if have_ref and any(not c["ok"] for c in checks):
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
