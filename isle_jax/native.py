"""ctypes bindings to the native C++ I/O library (libisle_io.so).

The reference implements its I/O layer natively (mmap parse of TDF triples,
include/utils.h:96-229; buffered mmap writer with hand-rolled formatters,
include/utils.h:232-487). We do the same: native/isle_io.cpp provides a
multi-pass mmap parser and a buffered text writer; this module loads it and
falls back to numpy implementations when the shared library has not been
built (e.g. fresh checkouts before `make -C native`).
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import numpy as np

_LIB_PATHS = [
    os.path.join(os.path.dirname(__file__), "..", "native", "libisle_io.so"),
    os.path.join(os.path.dirname(__file__), "libisle_io.so"),
]

_lib: Optional[ctypes.CDLL] = None


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    for p in _LIB_PATHS:
        p = os.path.abspath(p)
        if os.path.exists(p):
            try:
                lib = ctypes.CDLL(p)
            except OSError:
                continue
            lib.isle_count_entries.restype = ctypes.c_int64
            lib.isle_count_entries.argtypes = [ctypes.c_char_p]
            lib.isle_parse_tdf.restype = ctypes.c_int64
            lib.isle_parse_tdf.argtypes = [
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int64,
            ]
            lib.isle_write_sparse_model.restype = ctypes.c_int64
            lib.isle_write_sparse_model.argtypes = [
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_float),
                ctypes.c_int64,
                ctypes.c_int64,
                ctypes.c_int32,
            ]
            lib.isle_sort_dedup_entries.restype = ctypes.c_int64
            lib.isle_sort_dedup_entries.argtypes = [
                ctypes.POINTER(ctypes.c_int64)
            ] * 3 + [ctypes.c_int64]
            lib.isle_order_by.restype = ctypes.c_int64
            lib.isle_order_by.argtypes = [
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int64,
            ]
            for name, third in (
                ("isle_write_if_triples", ctypes.POINTER(ctypes.c_float)),
                ("isle_write_iii_triples", ctypes.POINTER(ctypes.c_int32)),
            ):
                fn = getattr(lib, name, None)
                if fn is None:
                    continue  # stale .so without the triple writers
                fn.restype = ctypes.c_int64
                fn.argtypes = [
                    ctypes.c_char_p,
                    ctypes.POINTER(ctypes.c_int32),
                    ctypes.POINTER(ctypes.c_int32),
                    third,
                    ctypes.c_int64,
                ] + [ctypes.c_int32] * (
                    2 if name == "isle_write_if_triples" else 3
                )
            _lib = lib
            return _lib
    return None


def have_native() -> bool:
    return _load() is not None


def parse_tdf(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Parse 1-based `<doc> <word> <count>` lines into 0-based int64 arrays.

    Native path: two-pass mmap parser (count then fill). Fallback: numpy
    fromstring-style parse.
    """
    lib = _load()
    if lib is not None:
        n = lib.isle_count_entries(path.encode())
        if n < 0:
            raise OSError(f"cannot read {path}")
        docs = np.empty(n, dtype=np.int64)
        words = np.empty(n, dtype=np.int64)
        counts = np.empty(n, dtype=np.int64)
        got = lib.isle_parse_tdf(
            path.encode(),
            docs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            words.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            n,
        )
        if got < 0:
            raise OSError(f"parse failed for {path}")
        return docs[:got] - 1, words[:got] - 1, counts[:got]
    return _parse_tdf_numpy(path)


def _parse_tdf_numpy(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    with open(path, "rb") as f:
        data = f.read()
    arr = np.array(data.split(), dtype=np.int64)
    if arr.size % 3 != 0:
        raise ValueError(f"{path}: token count {arr.size} not a multiple of 3")
    arr = arr.reshape(-1, 3)
    return arr[:, 0] - 1, arr[:, 1] - 1, arr[:, 2]


def sort_dedup_entries(docs, words, counts):
    """Sort by (doc, word), first-occurrence dedup. Native when available
    (numpy's multi-pass lexsort is a bottleneck at corpus scale); numpy
    fallback otherwise. Returns new arrays.

    Native error codes: -1 = allocation failure, -2 = n > 2^32-1 (the
    radix sort carries u32 original indices). Both fall back to the numpy
    lexsort below, which indexes 64-bit and has no such cap."""
    lib = _load()
    n = len(docs)
    if lib is not None and n and int(docs.max()) < 2**31 and int(words.max()) < 2**31:
        d = np.ascontiguousarray(docs, np.int64)
        w = np.ascontiguousarray(words, np.int64)
        c = np.ascontiguousarray(counts, np.int64)
        m = lib.isle_sort_dedup_entries(
            d.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            w.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            c.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            n,
        )
        if m >= 0:
            return d[:m], w[:m], c[:m]
    order = np.lexsort((words, docs))
    docs, words, counts = docs[order], words[order], counts[order]
    if len(docs) > 1:
        keep = np.empty(len(docs), dtype=bool)
        keep[0] = True
        keep[1:] = (docs[1:] != docs[:-1]) | (words[1:] != words[:-1])
        docs, words, counts = docs[keep], words[keep], counts[keep]
    return docs, words, counts


def order_by(major: np.ndarray, minor: np.ndarray) -> np.ndarray:
    """Permutation sorting by (major, minor), stable. Native when possible."""
    lib = _load()
    n = len(major)
    if lib is not None and n:
        ma = np.ascontiguousarray(major, np.int32)
        mi = np.ascontiguousarray(minor, np.int32)
        perm = np.empty(n, np.int64)
        rc = lib.isle_order_by(
            ma.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            mi.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            perm.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            n,
        )
        if rc == 0:
            return perm
    return np.lexsort((minor, major))


def write_float_triples(
    path: str,
    a: np.ndarray,
    b: np.ndarray,
    v: np.ndarray,
    base_a: int = 1,
    base_b: int = 1,
) -> None:
    """Write `<a+base_a>\\t<b+base_b>\\t<v:.6f>` lines through the native
    buffered writer (the reference's MMappedOutput concat_int/concat_float
    path, include/utils.h:232-487). Byte-identical numpy/python fallback.
    Used by the per-entry artifact writers (DocCatchword.tsv,
    DocTopicCatchwordSums.tsv, inference top-topics files), which at
    corpus scale emit millions of lines — per-line Python f-strings take
    minutes there."""
    a = np.ascontiguousarray(a, np.int32)
    b = np.ascontiguousarray(b, np.int32)
    v = np.ascontiguousarray(v, np.float32)
    n = len(a)
    assert len(b) == n and len(v) == n
    lib = _load()
    if lib is not None and hasattr(lib, "isle_write_if_triples"):
        rc = lib.isle_write_if_triples(
            path.encode(),
            a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            b.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            v.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            n,
            base_a,
            base_b,
        )
        if rc < 0:
            raise OSError(f"cannot write {path}")
        return
    with open(path, "w") as f:
        for i in range(n):
            f.write(f"{a[i] + base_a}\t{b[i] + base_b}\t{v[i]:.6f}\n")


def write_int_triples(
    path: str,
    a: np.ndarray,
    b: np.ndarray,
    c: np.ndarray,
    base_a: int = 1,
    base_b: int = 1,
    base_c: int = 1,
) -> None:
    """`<a>\\t<b>\\t<c>` integer lines (TopTwoTopicsPerDoc.txt,
    src/trainer.cpp:1008-1040) through the native buffered writer."""
    a = np.ascontiguousarray(a, np.int32)
    b = np.ascontiguousarray(b, np.int32)
    c = np.ascontiguousarray(c, np.int32)
    n = len(a)
    assert len(b) == n and len(c) == n
    lib = _load()
    if lib is not None and hasattr(lib, "isle_write_iii_triples"):
        rc = lib.isle_write_iii_triples(
            path.encode(),
            a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            b.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            c.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            n,
            base_a,
            base_b,
            base_c,
        )
        if rc < 0:
            raise OSError(f"cannot write {path}")
        return
    with open(path, "w") as f:
        for i in range(n):
            f.write(f"{a[i] + base_a}\t{b[i] + base_b}\t{c[i] + base_c}\n")


def write_sparse_model(
    path: str, model_colmajor: np.ndarray, base: int = 1
) -> None:
    """Write `<topic> <word> <weight>` lines for entries > 1e-8, matching
    DenseMatrix::write_to_file_as_sparse (src/denseMatrix.cpp:153-187):
    topic-major order, `base`-based ids, tab separators."""
    model = np.asarray(model_colmajor, dtype=np.float32)
    vocab, ntopics = model.shape
    lib = _load()
    if lib is not None:
        # The C writer indexes column-major: model[w + t * vocab].
        buf = np.ascontiguousarray(model.T)
        rc = lib.isle_write_sparse_model(
            path.encode(),
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            vocab,
            ntopics,
            base,
        )
        if rc < 0:
            raise OSError(f"cannot write {path}")
        return
    with open(path, "w") as f:
        for t in range(ntopics):
            col = model[:, t]
            idx = np.nonzero(col > 1e-8)[0]
            for w in idx:
                f.write(f"{t + base}\t{w + base}\t{col[w]:.10f}\n")
