"""Flat, handle-based embedding API.

Mirrors the reference's C shared-library export layer used for TLC/ML.NET
hosting (drivers/trainer_export.cpp:31-99): CreateTrainer / feedData /
finalizeData / Train / GetBasicModel / GetNumEdgeTopics / GetEdgeModel /
DestroyTrainer. Here the host is any Python-embedding process (or ctypes
callers through python's C API); model buffers are returned as flat
float32 arrays in the same column-major (vocab-major) layout the reference
memcpy's out (src/trainer.cpp:993-1006)."""

from __future__ import annotations

import os
import tempfile
import threading
from typing import Dict, Optional

import numpy as np

from .config import TrainConfig
from .trainer import Trainer

_handles: Dict[int, Trainer] = {}
_next_handle = 1
_lock = threading.Lock()


def CreateTrainer(
    vocab_size: int,
    num_docs: int,
    num_topics: int,
    output_dir: str = os.path.join(tempfile.gettempdir(), "isle_jax_capi"),
    sample_docs: bool = False,
    sample_rate: float = 0.0,
    compute_edge_topics: bool = False,
    max_edge_topics: int = 0,
    seed: int = 0,
    log_callback=None,
) -> int:
    """Returns an opaque handle. `log_callback(msg)` plays the role of the
    reference's injectable C log sinks (include/logger.h:25-29)."""
    global _next_handle
    cfg = TrainConfig(
        num_topics=num_topics,
        vocab_size=vocab_size,
        num_docs=num_docs,
        sample_docs=sample_docs,
        sample_rate=sample_rate,
        compute_edge_topics=compute_edge_topics,
        max_edge_topics=max_edge_topics,
        seed=seed,
    )
    tr = Trainer(cfg, output_dir=output_dir, quiet=True)
    if log_callback is not None:
        for ch in ("info", "warning", "error"):
            tr.logger.add_sink(ch, log_callback)
    with _lock:
        h = _next_handle
        _next_handle += 1
        _handles[h] = tr
    return h


def feedData(handle: int, doc: int, words, counts, num_words: int) -> None:
    """words are 1-based, as in the reference feed path
    (src/trainer.cpp:214-228)."""
    tr = _handles[handle]
    tr.feed_data(doc, np.asarray(words)[:num_words], np.asarray(counts)[:num_words])


def finalizeData(handle: int) -> None:
    _handles[handle].finalize_data()


def Train(handle: int) -> None:
    tr = _handles[handle]
    tr.train()
    if tr.config.compute_edge_topics:
        tr.train_edge_topics()


def GetBasicModel(handle: int) -> np.ndarray:
    """Flat float32 of length vocab*num_topics, topic-major columns of
    length vocab (column-major memcpy layout)."""
    tr = _handles[handle]
    return np.ascontiguousarray(tr.get_model().T).reshape(-1)


def GetNumEdgeTopics(handle: int) -> int:
    tr = _handles[handle]
    em = tr.get_edge_model()
    return 0 if em is None else em.shape[1]


def GetEdgeModel(handle: int) -> Optional[np.ndarray]:
    tr = _handles[handle]
    em = tr.get_edge_model()
    return None if em is None else np.ascontiguousarray(em.T).reshape(-1)


def DestroyTrainer(handle: int) -> None:
    with _lock:
        tr = _handles.pop(handle, None)
    if tr is not None:
        tr.logger.close()
