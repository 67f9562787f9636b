"""Cross-mode config matrix: every {training mode} x {eigensolver} x
{k-means algo} combination must either RUN (producing a valid model) or
raise explicitly — never silently fall back to a default solver (the
round-2 gap: StreamedTrainer hardcoded block_ks+Lloyd's, the sharded
path silently ran block_ks under eigensolver='dense').
"""


import numpy as np
import pytest

from isle_jax.config import HyperParams, DeviceConfig, TrainConfig
from isle_jax.streaming import StreamedTrainer
from isle_jax.trainer import Trainer
from test_end_to_end import planted_corpus

# Smallest shape that exercises every combo's code path (this matrix
# checks "runs or raises explicitly", not statistical quality — the
# equality/quality tests live in test_sharded_trainer/test_streaming).
V, D, K = 48, 160, 4

# (mode, eigensolver, kmeans) -> expected exception type. Empty as of
# round 4: every combination runs — the sharded dense oracle gathers B
# to host (matops.mat_to_dense on sharded layouts) and Elkan's runs on
# the mesh with cross-shard-max mini buckets (elkans_sharded.py).
EXPECTED_ERRORS = {}


@pytest.fixture(scope="module")
def tdf_path(tmp_path_factory):
    rng = np.random.default_rng(23)
    text, _ = planted_corpus(rng, V, D, K)
    tmp = tmp_path_factory.mktemp("cfgmat")
    tdf = tmp / "c.tdf"
    tdf.write_text(text)
    return str(tdf)


@pytest.mark.parametrize("mode", ["incore", "sharded", "streamed"])
@pytest.mark.parametrize("eigensolver", ["block_ks", "lanczos", "dense"])
@pytest.mark.parametrize("kmeans", ["lloyds", "elkans"])
def test_config_combo(tdf_path, tmp_path, mode, eigensolver, kmeans):
    hp = HyperParams(
        eigensolver=eigensolver,
        kmeans_algo_for_sparse=kmeans,
        block_ks_block_size=8,
    )
    dev = DeviceConfig(mesh_shape=(4,)) if mode == "sharded" else DeviceConfig()
    cfg = TrainConfig(num_topics=K, seed=0, hyper=hp, device=dev)
    out = str(tmp_path / f"{mode}_{eigensolver}_{kmeans}")
    if mode == "streamed":
        tr = StreamedTrainer(cfg, output_dir=out, chunk_entries=512)
    else:
        tr = Trainer(cfg, output_dir=out, quiet=True)
    tr.load_data_from_file(tdf_path)

    expected = tuple(
        e
        for key in ((mode, eigensolver), (mode, kmeans))
        if (e := EXPECTED_ERRORS.get(key)) is not None
    )
    if expected:
        with pytest.raises(expected):
            tr.train()
        return
    tr.train()
    assert tr.is_training_complete
    model = tr.model
    assert model.shape == (V, K)
    sums = model.sum(axis=0)
    # every topic column is l1-normalized (or all-zero for empty topics)
    assert np.all((np.abs(sums - 1.0) < 1e-3) | (sums == 0.0))
    assert np.isfinite(model).all()
    # eigenvalues must be populated by whichever solver ran
    assert tr.evalues is not None and len(tr.evalues) == K


def test_unknown_eigensolver_raises(tdf_path, tmp_path):
    cfg = TrainConfig(
        num_topics=K, seed=0, hyper=HyperParams(eigensolver="qr_iteration")
    )
    tr = Trainer(cfg, output_dir=str(tmp_path), quiet=True)
    tr.load_data_from_file(tdf_path)
    with pytest.raises(ValueError):
        tr.train()
