"""The platform policy (config.py), the compile-cache rule and the chip
smoke script's refusal to run without GPUs."""

import os
import subprocess
import sys
import types
from pathlib import Path

import pytest

REPO_ROOT = Path(__file__).parent.parent


@pytest.mark.parametrize("backend", ["gpu", "cpu"])
def test_policy_dtypes_do_not_depend_on_platform(monkeypatch, backend):
    """One rule for every platform: float32 model compute and float32 LSTM
    operands unless an env var opts into bfloat16."""
    import jax
    import jax.numpy as jnp

    from frechet_audio_distance_exported_tpu import config

    for var in ("FAD_TPU_MODEL_DTYPE", "FAD_TPU_LSTM_MATMUL", "FAD_TPU_PRECISION"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert config.model_dtype() == jnp.float32
    assert config.lstm_op_dtype() == jnp.float32


def test_default_file_batch_per_family(monkeypatch):
    from frechet_audio_distance_exported_tpu import config
    from frechet_audio_distance_exported_tpu import pipeline as pl

    assert config.DEFAULT_FILE_BATCH == {"vggish": 32, "pann": 32, "clap": 32, "encodec": 16}
    monkeypatch.setattr(pl, "_device_hbm_bytes", lambda: None)
    pl.hbm_batch_scale.cache_clear()
    try:
        assert pl.EmbeddingPipeline("pann-16k", params={}).file_batch == 32
        assert pl.EmbeddingPipeline("encodec-48k", params={}).file_batch == 16
    finally:
        pl.hbm_batch_scale.cache_clear()


def test_compile_cache_env_var_is_honoured(monkeypatch):
    """With JAX_COMPILATION_CACHE_DIR set the program sets no directory."""
    import jax

    from frechet_audio_distance_exported_tpu import config

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    before = jax.config.jax_compilation_cache_dir
    assert config.compilation_cache_dir() is None
    config.enable_compilation_cache()
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_fixed_path_when_unset(monkeypatch):
    import jax

    from frechet_audio_distance_exported_tpu import config

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        config.enable_compilation_cache()
        assert jax.config.jax_compilation_cache_dir == str(REPO_ROOT / ".jax_compile_cache")
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    assert ".jax_compile_cache/" in (REPO_ROOT / ".gitignore").read_text().splitlines()


def test_compile_cache_path_identical_across_calls(monkeypatch):
    """No temp, pid or time component: the path is part of the cache key."""
    from frechet_audio_distance_exported_tpu import config

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    first = config.compilation_cache_dir()
    assert first == config.compilation_cache_dir() == str(config.COMPILE_CACHE_DIR)


def test_chip_smoke_fails_without_gpu():
    r = subprocess.run(
        [sys.executable, str(REPO_ROOT / "chip_smoke.py")],
        capture_output=True, text=True, timeout=300, cwd=str(REPO_ROOT),
        env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "no GPU" in r.stderr


def test_chip_smoke_four_gpu_refuses_fewer_devices():
    sys.path.insert(0, str(REPO_ROOT))
    import chip_smoke

    gpu = types.SimpleNamespace(platform="gpu", device_kind="NVIDIA H100")
    chip_smoke.check_devices([gpu], 1)  # one GPU is enough without --four-gpu
    with pytest.raises(SystemExit, match="needs 4 GPUs"):
        chip_smoke.check_devices([gpu], chip_smoke.MESH_DEVICES)
    with pytest.raises(SystemExit, match="no GPU"):
        chip_smoke.check_devices([types.SimpleNamespace(platform="cpu")], 1)
    chip_smoke.check_devices([gpu] * 4, chip_smoke.MESH_DEVICES)
