"""Ingest: sort/dedup, CSC assembly, normalization semantics."""

import numpy as np
import pytest

from isle_jax.corpus import Corpus, EntryFeeder, read_tdf_entries

pytestmark = pytest.mark.quick  # <60s smoke tier


def test_sort_dedup_and_csc():
    docs = np.array([2, 0, 0, 2, 0, 1], dtype=np.int64)
    words = np.array([5, 3, 1, 5, 3, 2], dtype=np.int64)  # (0,3) dup, (2,5) dup
    counts = np.array([4, 2, 1, 9, 7, 3], dtype=np.int64)
    c = Corpus.from_entries(docs, words, counts, vocab_size=6, num_docs=4)
    # Duplicates keep the first occurrence after stable (doc, word) sort.
    assert c.nnz == 4
    np.testing.assert_array_equal(c.offsets, [0, 2, 3, 4, 4])
    np.testing.assert_array_equal(c.rows, [1, 3, 2, 5])
    # doc 3 is empty.
    assert c.nz_docs == 3
    # avg_doc_sz uses integer division: total = 1+2+3+4 = 10, 10 // 3 = 3.
    assert c.avg_doc_sz == 3.0
    # Normalization to avg_doc_sz: doc 0 sum = 3 -> [1, 2], doc1 -> [3], doc2 -> [3]
    np.testing.assert_allclose(c.vals, [1.0, 2.0, 3.0, 3.0], rtol=1e-6)


def test_normalize_to_one():
    docs = np.array([0, 0, 1], dtype=np.int64)
    words = np.array([0, 1, 1], dtype=np.int64)
    counts = np.array([1, 3, 5], dtype=np.int64)
    c = Corpus.from_entries(
        docs, words, counts, vocab_size=2, num_docs=2, normalize_to_one=True
    )
    np.testing.assert_allclose(c.vals, [0.25, 0.75, 1.0], rtol=1e-6)


def test_int_normalized_counts():
    """USE_INT_NORMALIZED_COUNTS build (include/types.h:82-86): normalized
    values become ceil(avg_doc_sz * count / doc_sum) integers
    (src/sparseMatrix.cpp:149-152, count_t branch)."""
    docs = np.array([0, 0, 1], dtype=np.int64)
    words = np.array([0, 1, 1], dtype=np.int64)
    counts = np.array([1, 3, 5], dtype=np.int64)
    # total = 9, nz_docs = 2 -> avg_doc_sz = 9 // 2 = 4
    c = Corpus.from_entries(
        docs, words, counts, vocab_size=2, num_docs=2, int_normalized=True
    )
    assert c.avg_doc_sz == 4.0
    # doc0 sum 4: ceil(4*1/4)=1, ceil(4*3/4)=3; doc1 sum 5: ceil(4*5/5)=4
    np.testing.assert_array_equal(c.vals, [1.0, 3.0, 4.0])
    assert (c.vals == np.floor(c.vals)).all()
    # Incompatible with unit-mass normalization (reference asserts,
    # src/sparseMatrix.cpp:150).
    import pytest

    with pytest.raises(AssertionError):
        Corpus.from_entries(
            docs, words, counts, vocab_size=2, num_docs=2,
            int_normalized=True, normalize_to_one=True,
        )


def test_doc_ids_flat():
    docs = np.array([0, 1, 1, 3], dtype=np.int64)
    words = np.array([0, 1, 2, 0], dtype=np.int64)
    counts = np.ones(4, dtype=np.int64)
    c = Corpus.from_entries(docs, words, counts, vocab_size=3, num_docs=4)
    np.testing.assert_array_equal(c.doc_ids(), [0, 1, 1, 3])


def test_tdf_roundtrip(tmp_path):
    p = tmp_path / "corpus.tdf"
    p.write_text("1 3 2\n1 1 1\n2 2 5\n3 1 1\n")
    docs, words, counts = read_tdf_entries(str(p))
    np.testing.assert_array_equal(docs, [0, 0, 1, 2])
    np.testing.assert_array_equal(words, [2, 0, 1, 0])
    np.testing.assert_array_equal(counts, [2, 1, 5, 1])
    c = Corpus.from_tdf_file(str(p))
    assert c.num_docs == 3 and c.vocab_size == 3
    assert c.nnz == 4


def test_entry_feeder():
    f = EntryFeeder()
    f.feed(0, np.array([1, 3]), np.array([2, 1]))  # 1-based words
    f.feed(1, np.array([2]), np.array([4]))
    c = f.finalize()
    assert c.vocab_size == 3 and c.num_docs == 2
    np.testing.assert_array_equal(c.rows, [0, 2, 1])


def test_trailing_empty_docs():
    docs = np.array([0], dtype=np.int64)
    words = np.array([0], dtype=np.int64)
    counts = np.array([7], dtype=np.int64)
    c = Corpus.from_entries(docs, words, counts, vocab_size=1, num_docs=5)
    np.testing.assert_array_equal(c.offsets, [0, 1, 1, 1, 1, 1])
    assert c.nz_docs == 1 and c.avg_doc_sz == 7.0


def test_trailing_empty_docs_doc_sums():
    """Trailing empty docs must not corrupt the last non-empty doc's sum
    (round-4 review, confirmed: the old reduceat clamp stole every entry
    after the first from its sum, mis-normalizing inference blocks whose
    final docs are empty)."""
    c = Corpus.from_entries(
        np.array([0, 0]), np.array([1, 2]), np.array([3, 5]),
        vocab_size=4, num_docs=3,
    )
    np.testing.assert_array_equal(c.doc_sums(), [8.0, 1.0, 1.0])
    c1 = Corpus.from_entries(
        np.array([0, 0]), np.array([1, 2]), np.array([3, 5]),
        vocab_size=4, num_docs=3, normalize_to_one=True,
    )
    np.testing.assert_allclose(c1.vals[:c1.nnz], [3 / 8, 5 / 8])
