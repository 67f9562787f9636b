"""The full-entry XLA accumulations — threshold histogram, r-th group
counts, doc-topic mass, and the model SpMM b_y — against plain np.add.at
references, on the stream shapes that stress a sorted segment sum: one
long run, runs straddling scan-chunk boundaries, a padded spill tail,
and masked (-1) columns. Counts are compared exactly, values at f32
round-off."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from isle_jax.catchwords import _count_scan, _entry_groups
from isle_jax.sparse import DocSparse, b_y
from isle_jax.thresholds import banked_hist
from isle_jax.topic_model import doc_topic_mass

pytestmark = pytest.mark.quick  # <60s smoke tier

V, D, K = 40, 300, 6
SCAN = 64  # scan chunk: runs of > 64 entries straddle chunk boundaries
CASES = ["single_run", "straddle", "spill", "masked", "random"]


def make_case(name: str):
    """(DocSparse, cluster_of_doc, cw_topic) with COO entries doc-sorted."""
    rng = np.random.default_rng(CASES.index(name))
    if name == "single_run":
        # every doc holds the same single word: one run of D entries
        w = np.full(D, 7)
        d = np.arange(D)
    else:
        density = 0.02 if name == "spill" else 0.25
        mask = rng.random((D, V)) < density
        if name == "straddle":
            mask[:, 3] = True  # word 3 runs through every scan chunk
            mask[: 2 * SCAN + 5, 11] = True
        d, w = np.nonzero(mask)
    v = (rng.integers(1, 9, len(w)) * 1.25).astype(np.float32)
    # "spill" pads the stream to 8x its length with spill entries
    chunk = 2048 if name == "spill" else SCAN
    A = DocSparse.build(w, d, v, V, D, chunk=chunk)
    cluster = rng.integers(0, K, D).astype(np.int32)
    cwt = rng.integers(0, K, V).astype(np.int32)
    if name == "masked":
        cluster[rng.random(D) < 0.6] = -1
        cwt[rng.random(V) < 0.6] = -1
    else:
        cluster[::7] = -1
        cwt[::3] = -1
    return A, w.astype(np.int64), d.astype(np.int64), v, cluster, cwt


@pytest.mark.parametrize("case", CASES)
def test_threshold_histogram_counts(case):
    A, w, d, v, _, _ = make_case(case)
    F = 12
    r = jnp.clip(jnp.floor(A.d_val + 0.5).astype(jnp.int32), 0, F)
    got = np.asarray(jax.jit(banked_hist, static_argnums=(2, 3, 4))(
        A.d_word, r, V + 1, F, SCAN))
    ref = np.zeros((V + 1, F + 1), np.int64)
    rr = np.clip(np.floor(v + 0.5).astype(np.int64), 0, F)
    np.add.at(ref, (w, rr), 1)
    n_pad = A.padded_nnz - len(w)
    ref[V, 0] += n_pad  # padded entries: spill word, value 0
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("case", CASES)
def test_rth_group_counts(case):
    A, w, d, v, cluster, _ = make_case(case)
    key, in_cluster = _entry_groups(A, jnp.asarray(cluster), K)
    got = np.asarray(jax.jit(_count_scan, static_argnums=(2, 3))(
        key, in_cluster, V, K))
    ref = np.zeros((V + 1, K), np.int64)
    keep = cluster[d] >= 0
    np.add.at(ref, (w[keep], cluster[d][keep]), 1)
    np.testing.assert_array_equal(got[:V], ref[:V])
    assert got[V].sum() == 0  # spill key rows carry no in-cluster count


@pytest.mark.parametrize("case", CASES)
def test_doc_topic_mass_values(case):
    A, w, d, v, _, cwt = make_case(case)
    got = np.asarray(doc_topic_mass(A, jnp.asarray(cwt), K, SCAN))
    ref = np.zeros((D, K), np.float64)
    keep = cwt[w] >= 0
    np.add.at(ref, (d[keep], cwt[w][keep]), v[keep])
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("case", CASES)
def test_model_b_y_values(case):
    A, w, d, v, cluster, _ = make_case(case)
    Y = np.random.default_rng(5).standard_normal((D, K)).astype(np.float32)
    Y[cluster < 0] = 0.0  # unclustered docs contribute nothing
    got = np.asarray(b_y(A, jnp.asarray(Y), SCAN))
    ref = np.zeros((V, K), np.float64)
    np.add.at(ref, w, v[:, None].astype(np.float64) * Y[d])
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)
