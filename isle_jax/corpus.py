"""Host-side corpus ingest: term-document-frequency parsing, entry
sort/dedup, CSC assembly, and per-document normalization.

Rebuilds the behavior of the reference ingest path
(reference: include/utils.h:96-229 `DocWordEntriesReader`,
src/trainer.cpp:214-362 `feed_data`/`finalize_data`,
src/sparseMatrix.cpp:58-167 `populate_CSC`/`normalize_docs`) as vectorized
numpy. The heavy lifting downstream happens on the device; ingest runs once on
the host and produces flat arrays that upload cleanly.

Conventions (identical to the reference, include/sparseMatrix.h:31-38):
the term-document matrix is CSC with documents as columns and words as
rows, 0-based. TDF text files are 1-based `<doc_id> <word_id> <count>`
triples.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np


def read_tdf_entries(
    path: str, max_entries: Optional[int] = None
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Parse a 1-based TDF file into 0-based (doc, word, count) arrays.

    Mirrors DocWordEntriesReader::read_from_file (include/utils.h:104-156):
    each line is `<doc> <word> <count>`; ids are converted to 0-based.
    Uses the native C++ parser when available, else a numpy fallback.
    """
    from . import native

    docs, words, counts = native.parse_tdf(path)
    if max_entries is not None and len(docs) > max_entries:
        docs, words, counts = (
            docs[:max_entries],
            words[:max_entries],
            counts[:max_entries],
        )
    return docs, words, counts


def _sort_dedup(
    docs: np.ndarray, words: np.ndarray, counts: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sort by (doc, word) and drop duplicate (doc, word) pairs, keeping the
    first occurrence (std::sort + std::unique, src/trainer.cpp:237-247).
    Dispatches to the native C++ sort (isle_io.cpp) when available."""
    from . import native

    return native.sort_dedup_entries(docs, words, counts)


@dataclasses.dataclass
class Corpus:
    """A normalized term-document matrix in host CSC form.

    Attributes
    ----------
    vocab_size, num_docs : logical dims (empty docs retained as zero cols).
    offsets : int64[num_docs+1] CSC column offsets.
    rows    : int32[nnz] word ids, sorted within each doc.
    counts  : float32[nnz] raw counts (the reference's vals_CSC).
    vals    : float32[nnz] normalized values (normalized_vals_CSC).
    avg_doc_sz : float; note the reference computes
        `(FPTYPE)(total_word_count / _nz_docs)` with INTEGER division
        (src/sparseMatrix.cpp:98) — replicated here for parity.
    nz_docs : number of non-empty documents.
    """

    vocab_size: int
    num_docs: int
    offsets: np.ndarray
    rows: np.ndarray
    counts: Optional[np.ndarray]
    vals: np.ndarray
    avg_doc_sz: float
    nz_docs: int

    @property
    def nnz(self) -> int:
        return int(self.offsets[-1])

    def doc_ids(self) -> np.ndarray:
        """Flattened doc id per nnz entry (COO row of the CSC layout)."""
        return np.repeat(
            np.arange(self.num_docs, dtype=np.int32),
            np.diff(self.offsets).astype(np.int64),
        )

    def doc_sums(self, empty_value: float = 1.0) -> np.ndarray:
        """Per-doc raw count sums in f32 (requires counts). Empty docs get
        `empty_value` (1.0 keeps later divisions harmless)."""
        assert self.counts is not None
        ds = np.full(self.num_docs, np.float32(empty_value), np.float32)
        if self.nnz:
            lengths = np.diff(self.offsets)
            # Boundary-sampled cumsum, NOT reduceat: reduceat requires
            # indices < nnz, and clamping trailing-empty-doc offsets to
            # nnz-1 silently stole entries from the LAST non-empty doc's
            # sum. f64 accumulate is exact
            # for integer counts.
            cs = np.concatenate(
                [[0.0], np.cumsum(self.counts, dtype=np.float64)]
            )
            s = (cs[self.offsets[1:]] - cs[self.offsets[:-1]]).astype(
                np.float32
            )
            s[lengths == 0] = empty_value
            ds[:] = s
        return ds

    def vals_match(self, expected_fn) -> bool:
        """True when `vals` equals `expected_fn(counts, per-entry
        doc_sums)` bitwise on EVERY entry — the guard the compact
        device-rebuild paths use before recomputing values from raw
        counts on device. Checked in full (one vectorized pass, cheap
        next to the upload it guards): Corpus is a plain dataclass whose
        vals callers can replace, and a sampled check could pass while
        unsampled entries differ."""
        if self.counts is None or self.nnz == 0:
            return False
        ds = self.doc_sums()
        per_entry = np.repeat(ds, np.diff(self.offsets).astype(np.int64))
        expect = expected_fn(self.counts, per_entry)
        return bool(np.array_equal(
            expect.astype(np.float32), self.vals.astype(np.float32)
        ))

    @staticmethod
    def from_entries(
        docs: np.ndarray,
        words: np.ndarray,
        counts: np.ndarray,
        vocab_size: int = 0,
        num_docs: int = 0,
        tf_idf: bool = False,
        normalize_to_one: bool = False,
        sort_dedup: bool = True,
        int_normalized: bool = False,
    ) -> "Corpus":
        """Assemble + normalize, mirroring finalize_data → populate_CSC →
        normalize_docs (src/trainer.cpp:232-299, src/sparseMatrix.cpp:58-167).

        normalize_to_one=False scales each doc to sum avg_doc_sz (training);
        True scales to unit sum (inference).

        int_normalized=True is the reference's USE_INT_NORMALIZED_COUNTS
        count_t build (include/types.h:82-86): normalized values become
        ceil(avg_doc_sz * count / doc_sum) integers
        (src/sparseMatrix.cpp:149-152) — stored here in the same float32
        vals array (all values are exact small integers). Incompatible
        with normalize_to_one (the reference asserts,
        src/sparseMatrix.cpp:150).
        """
        docs = np.asarray(docs)
        words = np.asarray(words)
        counts = np.asarray(counts)
        if sort_dedup:
            docs, words, counts = _sort_dedup(docs, words, counts)

        if num_docs == 0:
            num_docs = int(docs[-1]) + 1 if len(docs) else 0
        if vocab_size == 0:
            vocab_size = int(words.max()) + 1 if len(words) else 0

        if tf_idf:
            # NOTE: the reference's tf-idf reweighting loop iterates the
            # entry vector BY VALUE (`for (auto iter : entries) iter.count =
            # ...`, src/trainer.cpp:274-275), so it never modifies the data:
            # the flag is a no-op upstream. We implement the evidently
            # intended transform `count <- ceil(idf[word] * count)` with
            # idf = log(num_docs / doc_frequency); runs wanting bit-parity
            # with the reference should keep tf_idf=False.
            df = np.bincount(words, minlength=vocab_size).astype(np.float32)
            with np.errstate(divide="ignore"):
                idf = np.log(np.float32(num_docs) / df)
            counts = np.ceil(idf[words] * counts.astype(np.float32)).astype(counts.dtype)

        nnz = len(docs)
        offsets = np.zeros(num_docs + 1, dtype=np.int64)
        np.add.at(offsets, docs.astype(np.int64) + 1, 1)
        offsets = np.cumsum(offsets)
        assert offsets[-1] == nnz

        fcounts = counts.astype(np.float32)
        doc_sums = np.zeros(num_docs, dtype=np.float32)
        # Per-doc sums via boundary-sampled cumsum (see doc_sums(): the
        # old reduceat clamp corrupted the last non-empty doc's sum
        # whenever trailing empty docs exist).
        if nnz:
            cs = np.concatenate([[0.0], np.cumsum(counts, dtype=np.float64)])
            doc_sums = (cs[offsets[1:]] - cs[offsets[:-1]]).astype(
                np.float32
            )

        nz_mask = np.diff(offsets) > 0
        nz_docs = int(nz_mask.sum())
        total = int(counts.astype(np.uint64).sum()) if not tf_idf else int(
            fcounts.sum()
        )
        avg_doc_sz = float(np.float32(total // max(nz_docs, 1)))

        per_entry_sum = np.repeat(doc_sums, np.diff(offsets).astype(np.int64))
        if int_normalized:
            assert not normalize_to_one, (
                "USE_INT_NORMALIZED_COUNTS is a training-side count_t "
                "build; unit-mass normalization asserts in the reference "
                "(src/sparseMatrix.cpp:150)"
            )
            # normalized = ceil(avg_doc_sz * val / doc_sum) as an integer
            # (src/sparseMatrix.cpp:151-152, count_t branch).
            vals = np.ceil(
                np.float32(avg_doc_sz) * fcounts / per_entry_sum
            ).astype(np.float32)
        elif normalize_to_one:
            # normalized = val / doc_sum (src/sparseMatrix.cpp:157-158)
            vals = (fcounts / per_entry_sum).astype(np.float32)
        else:
            # normalized = avg_doc_sz * (val / doc_sum) — note the division
            # happens first in fp32 (src/sparseMatrix.cpp:158-159).
            vals = (np.float32(avg_doc_sz) * (fcounts / per_entry_sum)).astype(
                np.float32
            )

        return Corpus(
            vocab_size=vocab_size,
            num_docs=num_docs,
            offsets=offsets,
            rows=words.astype(np.int32),
            counts=fcounts,
            vals=vals,
            avg_doc_sz=avg_doc_sz,
            nz_docs=nz_docs,
        )

    @staticmethod
    def from_tdf_file(
        path: str,
        vocab_size: int = 0,
        num_docs: int = 0,
        max_entries: Optional[int] = None,
        tf_idf: bool = False,
        normalize_to_one: bool = False,
        doc_base_offset: int = 0,
        int_normalized: bool = False,
    ) -> "Corpus":
        docs, words, counts = read_tdf_entries(path, max_entries)
        if doc_base_offset:
            docs = docs - doc_base_offset
        return Corpus.from_entries(
            docs,
            words,
            counts,
            vocab_size=vocab_size,
            num_docs=num_docs,
            tf_idf=tf_idf,
            normalize_to_one=normalize_to_one,
            int_normalized=int_normalized,
        )


class EntryFeeder:
    """Iterative ingest, mirroring the C-API feed path
    (drivers/trainer_export.cpp:48-57 → src/trainer.cpp:214-228).
    Words arrive 1-based from the host, as in feed_data."""

    def __init__(self) -> None:
        self._docs: List[np.ndarray] = []
        self._words: List[np.ndarray] = []
        self._counts: List[np.ndarray] = []

    def feed(self, doc: int, words: np.ndarray, counts: np.ndarray) -> None:
        n = len(words)
        self._docs.append(np.full(n, doc, dtype=np.int64))
        self._words.append(np.asarray(words, dtype=np.int64) - 1)
        self._counts.append(np.asarray(counts))

    def finalize(
        self, vocab_size: int = 0, num_docs: int = 0, tf_idf: bool = False,
        int_normalized: bool = False,
    ) -> Corpus:
        docs = np.concatenate(self._docs) if self._docs else np.zeros(0, np.int64)
        words = np.concatenate(self._words) if self._words else np.zeros(0, np.int64)
        counts = (
            np.concatenate(self._counts) if self._counts else np.zeros(0, np.int64)
        )
        return Corpus.from_entries(
            docs, words, counts, vocab_size=vocab_size, num_docs=num_docs,
            tf_idf=tf_idf, int_normalized=int_normalized,
        )


def read_vocab_file(path: str, vocab_size: int) -> List[str]:
    """Word list, one word per line (src/utils.cpp:6-26)."""
    words: List[str] = []
    try:
        with open(path, "r", encoding="utf-8", errors="replace") as f:
            for line in f:
                words.append(line.strip())
                if len(words) >= vocab_size:
                    break
    except OSError:
        pass
    while len(words) < vocab_size:
        words.append(f"word_{len(words) + 1}")
    return words
