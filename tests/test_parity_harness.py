"""The parity harness itself under test (round-5 VERDICT item 5).

`parity/run_parity.py` is the golden reference-vs-rebuild comparator
(reference drivers/ISLETrain.cpp:9-32, ISLEInfer.cpp:10-36 CLI contract).
Until this file existed it had zero CI coverage — correct today, free to
bit-rot tomorrow.  Two legs:

- ours-only: always runs (no reference binaries needed) — exercises TDF
  synthesis, the 12-arg `cli.train` invocation, model discovery, and the
  report writer.
- full golden parity: runs whenever the MKL-shim reference build exists
  (`parity/build_reference.sh` → `parity/bin/ISLETrain`): both engines
  train the same tiny corpus, deterministic invariants must match, and
  cross-engine MWU inference must agree at 1e-4.

Both use tiny-syn (500 x 400, ~12k nnz, k=5) and spawn real subprocesses
— these are end-to-end CLI tests, not unit tests, hence no `quick` mark.
"""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNNER = os.path.join(REPO, "parity", "run_parity.py")
REF_BIN = os.path.join(REPO, "parity", "bin")


def _run_parity(tmp_path, ref_bin: str) -> dict:
    env = dict(os.environ)
    out = str(tmp_path / "out")
    p = subprocess.run(
        [sys.executable, RUNNER, "--dataset", "tiny-syn",
         "--ref-bin", ref_bin, "--data-dir", str(tmp_path / "data"),
         "--out", out, "--platform", "cpu"],
        capture_output=True, text=True, env=env, timeout=1200,
    )
    assert p.returncode == 0, (
        f"run_parity rc={p.returncode}\nstdout:\n{p.stdout[-4000:]}\n"
        f"stderr:\n{p.stderr[-4000:]}")
    rpath = os.path.join(out, "tiny-syn", "parity_tiny-syn.json")
    assert os.path.exists(rpath), f"no report at {rpath}"
    with open(rpath) as f:
        return json.load(f)


def test_run_parity_ours_only(tmp_path):
    """The harness's rebuild-only leg: synthesize the corpus, train via
    the 12-arg CLI, discover the model file, write the report."""
    report = _run_parity(tmp_path, ref_bin=str(tmp_path / "nobin"))
    assert report["dataset"] == "tiny-syn"
    assert report["docs"] == 400 and report["vocab"] == 500
    assert report["nnz"] > 0
    model = report["model_ours"]
    assert model and os.path.exists(model)
    # The model is the word-major sparse catchword file the reference's
    # ISLEInfer consumes (src/trainer.cpp:700-726 artifact).
    with open(model) as f:
        first = f.readline().split()
    assert len(first) == 3


@pytest.mark.skipif(
    not (os.path.exists(os.path.join(REF_BIN, "ISLETrain"))
         and os.path.exists(os.path.join(REF_BIN, "ISLEInfer"))),
    reason="reference binaries not built (parity/build_reference.sh)")
def test_run_parity_golden_vs_reference(tmp_path):
    """True golden parity: the MKL-shim reference build and the rebuild
    train the same TDF; invariants equal, cross-engine MWU at 1e-4."""
    report = _run_parity(tmp_path, ref_bin=REF_BIN)
    assert report["entries_above_threshold"]["ok"], report
    assert report["columns_remaining"]["ok"], report
    for tag in ("mwu_parity_oursmodel", "mwu_parity_refmodel"):
        leg = report[tag]
        assert isinstance(leg, dict) and leg["ok"], (tag, leg)
        assert leg["pairs"] > 100
