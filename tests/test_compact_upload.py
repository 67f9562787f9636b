"""Compact device construction must match the host-materialized path."""

import numpy as np
import pytest

from isle_jax.corpus import Corpus
from isle_jax.sparse import DocSparse

pytestmark = pytest.mark.quick  # <60s smoke tier


@pytest.mark.parametrize("seed", [0, 1])
def test_compact_matches_full(seed):
    rng = np.random.default_rng(seed)
    V, D = 50, 40
    docs, words, counts = [], [], []
    for d in range(D):
        if d % 7 == 3:  # empty docs sprinkled in
            continue
        ws = np.sort(rng.choice(V, rng.integers(1, 9), replace=False))
        for w in ws:
            docs.append(d)
            words.append(w)
            counts.append(int(rng.integers(1, 300)))
    c = Corpus.from_entries(
        np.array(docs), np.array(words), np.array(counts),
        vocab_size=V, num_docs=D,
    )
    a = DocSparse.from_corpus(c, chunk=256, compact_upload=True)
    b = DocSparse.from_corpus(c, chunk=256, compact_upload=False)
    for attr in ("d_word", "d_doc", "w_word", "w_doc"):
        np.testing.assert_array_equal(
            np.asarray(getattr(a, attr)), np.asarray(getattr(b, attr)), attr
        )
    for attr in ("d_val", "w_val"):
        np.testing.assert_array_equal(
            np.asarray(getattr(a, attr)), np.asarray(getattr(b, attr)), attr
        )


def test_trailing_empty_docs_compact():
    c = Corpus.from_entries(
        np.array([0, 1]), np.array([2, 0]), np.array([3, 4]),
        vocab_size=3, num_docs=6,
    )
    a = DocSparse.from_corpus(c, chunk=64)
    np.testing.assert_array_equal(np.asarray(a.d_doc)[:2], [0, 1])
    assert (np.asarray(a.d_doc)[2:] == 6).all()


def test_word_delta_codec_with_exceptions():
    """Delta codec round-trip with huge vocab gaps (deltas > 65534 go to
    the exception list), empty docs, and a doc starting at a big word id."""
    import jax.numpy as jnp

    from isle_jax.sparse import (
        _pad_exceptions,
        decode_word_deltas,
        encode_word_deltas,
    )

    V = 1 << 20
    rows = np.array(
        [5, 7, 100_000, 999_999,      # doc 0: two >65534 jumps
         70_000,                      # doc 2 (doc 1 empty): big absolute
         1, 2, 3],                    # doc 3: small deltas
        np.int64,
    )
    offsets = np.array([0, 4, 4, 5, 8], np.int64)
    d16, exc_i, exc_v = encode_word_deltas(rows, offsets)
    assert len(exc_i) >= 3  # 100000-7, 999999-100000, 70000 abs
    exc_ip, exc_vp = _pad_exceptions(exc_i, exc_v, len(rows))
    docs = np.repeat(np.arange(4), np.diff(offsets))
    starts = offsets[docs].astype(np.int32)
    dec = decode_word_deltas(
        jnp.asarray(d16), jnp.asarray(exc_ip), jnp.asarray(exc_vp),
        jnp.asarray(starts), jnp.ones(len(rows), bool), V,
    )
    np.testing.assert_array_equal(np.asarray(dec), rows)


def test_word_delta_codec_wraparound():
    """The int32 running sum may wrap across many docs; within-doc
    differences must still decode exactly (two's complement)."""
    import jax.numpy as jnp

    from isle_jax.sparse import (
        _pad_exceptions,
        decode_word_deltas,
        encode_word_deltas,
    )

    rng = np.random.default_rng(0)
    V = 2_000_000_000  # large ids so the global sum exceeds int32 fast
    D, per = 40, 3
    rows = np.sort(
        rng.integers(0, V, (D, per)).astype(np.int64), axis=1
    ).reshape(-1)
    offsets = np.arange(0, D * per + 1, per, dtype=np.int64)
    assert rows.sum() > (1 << 31)  # forces wraparound in the running sum
    d16, exc_i, exc_v = encode_word_deltas(rows, offsets)
    exc_ip, exc_vp = _pad_exceptions(exc_i, exc_v, len(rows))
    docs = np.repeat(np.arange(D), per)
    starts = offsets[docs].astype(np.int32)
    dec = decode_word_deltas(
        jnp.asarray(d16), jnp.asarray(exc_ip), jnp.asarray(exc_vp),
        jnp.asarray(starts), jnp.ones(len(rows), bool), V,
    )
    np.testing.assert_array_equal(np.asarray(dec), rows)


def test_nibble_counts_with_exceptions():
    """Nibble-packed counts (two per byte, counts >= 15 via the exception
    list) must rebuild values bit-identically, including at the odd/even
    pack positions and for large-count entries."""
    rng = np.random.default_rng(9)
    V, D = 40, 30
    docs = np.sort(rng.integers(0, D, 400))
    words = rng.integers(0, V, 400)
    order = np.lexsort((words, docs))
    docs, words = docs[order], words[order]
    keep = np.ones(len(docs), bool)
    keep[1:] = (docs[1:] != docs[:-1]) | (words[1:] != words[:-1])
    docs, words = docs[keep], words[keep]
    counts = rng.integers(1, 8, len(docs)).astype(np.int64)
    counts[::120] = rng.integers(15, 5000, len(counts[::120]))  # sparse exceptions keep the nibble path active (< 2%)
    c = Corpus.from_entries(docs, words, counts, vocab_size=V, num_docs=D,
                            sort_dedup=False)
    sp_fat = DocSparse.from_corpus(c, chunk=256, compact_upload=False)
    sp_cmp = DocSparse.from_corpus(c, chunk=256, compact_upload=True)
    assert (c.counts >= 15).mean() < 0.02  # nibble path is the one under test
    np.testing.assert_array_equal(
        np.asarray(sp_fat.d_word), np.asarray(sp_cmp.d_word)
    )
    np.testing.assert_array_equal(
        np.asarray(sp_fat.d_val), np.asarray(sp_cmp.d_val)
    )
    np.testing.assert_array_equal(
        np.asarray(sp_fat.w_val), np.asarray(sp_cmp.w_val)
    )
