"""Golden end-to-end fixture: the full pipeline's outputs on a fixed tiny
corpus, pinned to committed values.

The literal oracles (literal_oracle.py) pin each kernel's semantics; this
test pins the COMPOSED pipeline — an unintended change anywhere (stage
order, normalization, RNG schedule, a "fixed" reference quirk) shifts the
model and fails here even if every kernel oracle still passes. Tolerance
is loose enough (1e-4) to survive backend/jax arithmetic drift.

Regenerate after an INTENTIONAL semantic change:
    python tests/test_golden.py --regen
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))

FIXTURE = os.path.join(os.path.dirname(__file__), "golden_tiny.npz")


def _train(tmp_dir):
    from isle_jax.config import TrainConfig
    from isle_jax.corpus import Corpus
    from isle_jax.trainer import Trainer

    rng = np.random.default_rng(42)
    V, D, k = 400, 250, 5
    docs, words, counts = [], [], []
    for d in range(D):
        band = d % k
        n = int(rng.integers(10, 40))
        ws = np.unique(np.concatenate([
            rng.integers(band * 60, band * 60 + 60, n // 2),
            rng.integers(0, V, n - n // 2),
        ]))
        for w in np.sort(ws):
            docs.append(d)
            words.append(int(w))
            counts.append(int(rng.integers(1, 6)))
    corpus = Corpus.from_entries(
        np.array(docs), np.array(words), np.array(counts),
        vocab_size=V, num_docs=D,
    )
    cfg = TrainConfig(num_topics=k, seed=7, compute_edge_topics=True,
                      max_edge_topics=6)
    tr = Trainer(cfg, output_dir=tmp_dir, quiet=True)
    tr.corpus = corpus
    tr._post_ingest()
    tr.train()
    tr.train_edge_topics()
    is_cw = np.zeros((k, V), bool)
    for t, cw in enumerate(tr.catchwords):
        is_cw[t, cw] = True
    return dict(
        model=tr.model.astype(np.float32),
        edge_model=tr.edge_model.astype(np.float32),
        evalues=np.asarray(tr.evalues, np.float32),
        cluster_of_doc=tr.cluster_of_doc.astype(np.int32),
        is_cw=is_cw,
    )


def test_pipeline_matches_golden_fixture(tmp_path):
    assert os.path.exists(FIXTURE), (
        "fixture missing; run `python tests/test_golden.py --regen`"
    )
    got = _train(str(tmp_path))
    ref = np.load(FIXTURE)
    np.testing.assert_allclose(got["evalues"], ref["evalues"],
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(got["cluster_of_doc"],
                                  ref["cluster_of_doc"])
    np.testing.assert_array_equal(got["is_cw"], ref["is_cw"])
    np.testing.assert_allclose(got["model"], ref["model"],
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got["edge_model"], ref["edge_model"],
                               rtol=1e-4, atol=1e-6)


if __name__ == "__main__":
    if "--regen" in sys.argv:
        import tempfile

        import jax

        jax.config.update("jax_platforms", "cpu")
        with tempfile.TemporaryDirectory() as td:
            out = _train(td)
        np.savez(FIXTURE, **out)
        print(f"wrote {FIXTURE}")
