"""Threshold (ζ) kernel: vectorized numpy and jax versions must match the
literal restatement of the reference loop on adversarial random data."""

import numpy as np
import pytest

from isle_jax.config import HyperParams
from isle_jax.thresholds import compute_thresholds_jax, compute_thresholds_np
from literal_oracle import thresholds_literal

pytestmark = pytest.mark.quick  # <60s smoke tier


def make_corpus_vals(rng, vocab, n_entries, max_val):
    words = rng.integers(0, vocab, n_entries).astype(np.int32)
    # Values with heavy ties to exercise the count_eq walk; keep a spread of
    # magnitudes including sub-0.5 (rounds to zero) and exact .5 boundaries.
    vals = rng.choice(
        [0.2, 0.49, 0.5, 1.0, 1.49, 1.5, 2.0, 3.0, 3.5, 5.0, float(max_val)],
        size=n_entries,
    ).astype(np.float32)
    vals *= rng.choice([1.0, 1.0, 1.0, 0.999, 1.001], size=n_entries).astype(
        np.float32
    )
    return words, vals


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("k", [2, 5, 17])
def test_matches_literal(seed, k):
    rng = np.random.default_rng(seed)
    vocab, n = 97, 4000
    nz_docs = 300
    avg_doc_sz = 8.0
    words, vals = make_corpus_vals(rng, vocab, n, max_val=int(avg_doc_sz))
    hp = HyperParams()
    count_gr = hp.count_gr(nz_docs, k)
    count_eq = hp.count_eq(nz_docs, k)

    z_ref, nnz_ref = thresholds_literal(words, vals, vocab, count_gr, count_eq)
    z_np, nnz_np = compute_thresholds_np(
        words, vals, vocab, avg_doc_sz, nz_docs, k, hp
    )
    np.testing.assert_array_equal(z_np, z_ref)
    assert nnz_np == nnz_ref

    z_j, nnz_j = compute_thresholds_jax(
        words, vals, vocab, avg_doc_sz, nz_docs, k, hp
    )
    np.testing.assert_array_equal(np.asarray(z_j), z_ref)
    assert int(nnz_j) == nnz_ref


def test_absent_and_rare_words():
    hp = HyperParams()
    vocab = 10
    words = np.array([0, 0, 0, 1, 2], dtype=np.int32)
    vals = np.array([3.0, 3.0, 2.0, 0.3, 1.0], dtype=np.float32)
    nz_docs, k = 100, 2  # count_gr = 25 -> every word is "rare"
    z_ref, nnz_ref = thresholds_literal(
        words, vals, vocab, hp.count_gr(nz_docs, k), hp.count_eq(nz_docs, k)
    )
    z_np, nnz_np = compute_thresholds_np(words, vals, vocab, 4.0, nz_docs, k, hp)
    np.testing.assert_array_equal(z_np, z_ref)
    assert nnz_np == nnz_ref
    # Rare words throw everything in with zeta = 1; word 1 rounds to zero.
    assert z_np[0] == 1.0 and nnz_np == 4
    assert (z_np[3:] == 1.0).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize(
    "few_drop,bad_drop", [(True, False), (False, True), (True, True)]
)
def test_drop_flags_match_literal(seed, few_drop, bad_drop):
    """FEW_SAMPLES_THRESHOLD_DROP / BAD_THRESHOLD_DROP flipped branches
    (hyperparams.h:14-25): property-test both frontends vs the oracle."""
    rng = np.random.default_rng(seed)
    vocab, n = 97, 4000
    nz_docs, k = 300, 5
    avg_doc_sz = 8.0
    words, vals = make_corpus_vals(rng, vocab, n, max_val=int(avg_doc_sz))
    hp = HyperParams(
        few_samples_threshold_drop=few_drop, bad_threshold_drop=bad_drop
    )
    count_gr = hp.count_gr(nz_docs, k)
    count_eq = hp.count_eq(nz_docs, k)

    z_ref, nnz_ref = thresholds_literal(
        words, vals, vocab, count_gr, count_eq,
        few_drop=few_drop, bad_drop=bad_drop,
    )
    z_base, _ = thresholds_literal(words, vals, vocab, count_gr, count_eq)
    assert np.isinf(z_ref).any(), "case must exercise at least one drop"
    assert not np.array_equal(z_ref, z_base)

    z_np, nnz_np = compute_thresholds_np(
        words, vals, vocab, avg_doc_sz, nz_docs, k, hp
    )
    np.testing.assert_array_equal(z_np, z_ref)
    assert nnz_np == nnz_ref

    z_j, nnz_j = compute_thresholds_jax(
        words, vals, vocab, avg_doc_sz, nz_docs, k, hp
    )
    np.testing.assert_array_equal(np.asarray(z_j), z_ref)
    assert int(nnz_j) == nnz_ref


def test_drop_flags_rare_vs_exhausted_precedence():
    """A word that is BOTH too-few and would exhaust takes the too-few
    branch (the reference `continue`s before the walk,
    src/sparseMatrix.cpp:395-411)."""
    hp_few = HyperParams(few_samples_threshold_drop=True)
    hp_bad = HyperParams(bad_threshold_drop=True)
    vocab = 4
    # word 0: 3 heavily-tied entries (too few for count_gr=25, and the
    # walk would exhaust); word 1: absent.
    words = np.array([0, 0, 0], dtype=np.int32)
    vals = np.array([2.0, 2.0, 2.0], dtype=np.float32)
    nz_docs, k = 100, 2  # count_gr = 25
    z_few, nnz_few = compute_thresholds_np(
        words, vals, vocab, 4.0, nz_docs, k, hp_few
    )
    assert np.isinf(z_few[0]) and nnz_few == 0
    # With only bad_drop, the too-few branch still throws everything in.
    z_bad, nnz_bad = compute_thresholds_np(
        words, vals, vocab, 4.0, nz_docs, k, hp_bad
    )
    assert z_bad[0] == 1.0 and nnz_bad == 3
    # Absent words keep zeta = 1 under every flag combination (:478-480).
    assert z_few[1] == 1.0 and z_bad[1] == 1.0


def test_padded_entries_ignored_on_device():
    hp = HyperParams()
    vocab = 8
    words = np.array([0, 0, 1, vocab, vocab], dtype=np.int32)  # 2 padded
    vals = np.array([2.0, 2.0, 3.0, 99.0, 99.0], dtype=np.float32)
    z_j, nnz_j = compute_thresholds_jax(words, vals, vocab, 4.0, 10, 2, hp)
    z_np, nnz_np = compute_thresholds_np(
        words[:3], vals[:3], vocab, 4.0, 10, 2, hp
    )
    np.testing.assert_array_equal(np.asarray(z_j), z_np)
    assert int(nnz_j) == nnz_np
