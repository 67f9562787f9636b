"""isle-jax: a JAX framework with the capabilities of
microsoft/ISLE — provable SVD-based topic modeling at scale.

Public surface:
    Corpus, EntryFeeder        — host-side ingest (corpus.py)
    TrainConfig, InferConfig, HyperParams, DeviceConfig — configuration
    Trainer                    — end-to-end training pipeline (trainer.py)
    StreamedTrainer            — out-of-core training (streaming.py)
    Inferencer                 — batched MWU inference (inferencer.py)
"""

from .config import HyperParams, InferConfig, DeviceConfig, TrainConfig
from .corpus import Corpus, EntryFeeder

__all__ = [
    "HyperParams",
    "InferConfig",
    "DeviceConfig",
    "TrainConfig",
    "Corpus",
    "EntryFeeder",
    "Trainer",
    "StreamedTrainer",
    "Inferencer",
]


def __getattr__(name):
    # Lazy imports so lightweight users (ingest only) avoid jax start-up.
    if name == "Trainer":
        from .trainer import Trainer

        return Trainer
    if name == "StreamedTrainer":
        from .streaming import StreamedTrainer

        return StreamedTrainer
    if name == "Inferencer":
        from .inferencer import Inferencer

        return Inferencer
    raise AttributeError(name)
