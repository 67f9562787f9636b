"""What stays checkable on the CPU of the device-facing code: the
smoke script's device check and result line, the check helpers it runs on
the card (exercised here at a tiny size), the device-memory budget
reader, and the compilation-cache helper."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
from isle_jax.config import DeviceConfig
from isle_jax.obs import NoAcceleratorError, device_record, enable_compilation_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_device_record_refuses_cpu():
    with pytest.raises(NoAcceleratorError):
        device_record()


def test_chip_smoke_exits_nonzero_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "NoAcceleratorError" in out.stderr


def test_result_line_shape():
    line = chip_smoke.result_line(
        dict(platform="gpu", kind="NVIDIA H100 80GB HBM3", count=1, extra=0))
    assert line == ('{"ok": true, "device": {"platform": "gpu", '
                    '"kind": "NVIDIA H100 80GB HBM3", "count": 1}}')
    assert json.loads(line)["device"]["count"] == 1


def test_smoke_checks_pass_on_exact_operators():
    """The operator and distance checks read ~1e-7 at a tiny shape, far
    inside their bounds, which leave room only for summation order."""
    from isle_jax.bmatrix import threshold_and_copy
    from isle_jax.hybrid import hybrid_from_thresholds
    from isle_jax.sparse import DocSparse

    rng = np.random.default_rng(0)
    V, D = 300, 400
    mask = rng.random((D, V)) < np.linspace(0.6, 0.01, V)[None, :]
    d, w = np.nonzero(mask)
    A = DocSparse.build(w, d, rng.integers(1, 5, len(w)).astype(np.float32),
                        V, D, chunk=1024)
    zetas = jnp.ones((V,), jnp.float32)
    Bc, _ = threshold_and_copy(A, zetas, chunk=1024)
    Bh, _, _ = hybrid_from_thresholds(A, zetas, 40 * D * 2, chunk=1024)
    assert Bh.num_head >= 8
    errs = chip_smoke.operator_errors(Bh, Bc, width=16)
    assert max(errs.values()) <= chip_smoke.OP_TOL, errs
    P = jnp.asarray(rng.standard_normal((8, 500)).astype(np.float32))
    assert chip_smoke.lloyd_distance_error(P, P[:, :8].T) <= chip_smoke.DIST_TOL


def test_smoke_operator_check_catches_tf32_sized_error():
    """A 1e-3 relative perturbation (what a TF32 product leaves) fails."""
    ref = np.random.default_rng(1).standard_normal((64, 16))
    assert chip_smoke.rel_fro(ref * (1 + 1e-3), ref) > chip_smoke.OP_TOL


class _FakeDevice:
    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


@pytest.mark.parametrize("stats, explicit, want", [
    ({"bytes_limit": 60 << 30, "bytes_in_use": 1}, 0, 60 << 30),
    (None, 0, None),  # the CPU backend reports no stats
    ({}, 0, None),
    ({"bytes_limit": 60 << 30}, 8 << 30, 8 << 30),  # explicit value wins
])
def test_memory_budget(stats, explicit, want):
    cfg = DeviceConfig(hbm_bytes=explicit)
    assert cfg.memory_budget(_FakeDevice(stats)) == want


def test_memory_budget_plans_without_limit():
    from isle_jax.streaming import plan_middle_budget

    assert plan_middle_budget(None, 1 << 40, 10 ** 9, 4 << 30) == (True, 4 << 30)


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compilation_cache_honours_env(monkeypatch, tmp_path, restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert enable_compilation_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)


def test_compilation_cache_defaults_to_checkout(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = os.path.join(REPO, ".jax_cache")
    assert enable_compilation_cache() == want
    assert jax.config.jax_compilation_cache_dir == want
