"""Card-only numerics: the hybrid SpMM operators and a Lloyd's distance
step against their plain references at moderate widths. On a GPU an f32
product that is not pinned to Precision.HIGHEST may run in TF32 (~1e-3
relative error); these bounds (chip_smoke.OP_TOL, DIST_TOL) fail on that. Whether a card is
present is decided in the fixture, so every worker collects the same
tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bench import synth_corpus
from chip_smoke import DIST_TOL, OP_TOL, lloyd_distance_error, operator_errors

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def gpu():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (JAX found "
                    f"{jax.devices()[0].platform})")


@pytest.fixture(scope="module")
def b_pair(gpu):
    """(hybrid B, COO B) of one thresholded corpus at 20k x 40k, 2M nnz."""
    from isle_jax.bmatrix import threshold_and_copy
    from isle_jax.config import HyperParams
    from isle_jax.corpus import Corpus
    from isle_jax.hybrid import hybrid_from_thresholds
    from isle_jax.sparse import DocSparse
    from isle_jax.thresholds import compute_thresholds_jax

    V, D, k = 20_000, 40_000, 20
    d, w, c = synth_corpus(V, D, 2_000_000, seed=3)
    corpus = Corpus.from_entries(d, w, c, vocab_size=V, num_docs=D)
    A = DocSparse.from_corpus(corpus)
    zetas, _ = compute_thresholds_jax(A.d_word, A.d_val, V, corpus.avg_doc_sz,
                                      corpus.nz_docs, k, HyperParams())
    Bc, _ = threshold_and_copy(A, zetas)
    Bh, _, _ = hybrid_from_thresholds(A, zetas, 256 << 20)
    return Bh, Bc


@pytest.mark.parametrize("op", ["gram_x", "bt_x", "b_y"])
def test_hybrid_operator_matches_coo(b_pair, op):
    Bh, Bc = b_pair
    assert Bh.num_head > 0
    err = operator_errors(Bh, Bc)[op]
    assert err <= OP_TOL, f"h_{op} rel Frobenius error {err:.2e}"


def test_lloyd_distance_step_matches_float64(gpu):
    rng = np.random.default_rng(0)
    P = jnp.asarray(rng.standard_normal((100, 50_000)).astype(np.float32))
    centers = P[:, :100].T + 0.1
    err = lloyd_distance_error(P, centers)
    assert err <= DIST_TOL, f"distance rel Frobenius error {err:.2e}"
