"""Failure-detection behavior (SURVEY §5.3): per-file skip in
get_embeddings, the -1 sentinel, and whole-dir failure on undecodable files
(the reference re-raises decode errors from the thread pool, fad.py:591, so
one corrupt file fails the scoring call into the -1 sentinel — preserved
here as behavioral spec)."""

import os

import numpy as np
import pytest

from frechet_audio_distance_exported_tpu import FrechetAudioDistance
from frechet_audio_distance_exported_tpu.utils.audio_io import write_wav


@pytest.fixture(scope="module")
def fad():
    return FrechetAudioDistance(model_name="vggish", weights="random")


def test_corrupt_file_yields_sentinel(fad, tmp_path, sine_audio):
    bg, ev = tmp_path / "bg", tmp_path / "ev"
    os.makedirs(bg)
    os.makedirs(ev)
    for i in range(2):
        write_wav(str(bg / f"{i}.wav"), sine_audio(1.5, 440.0), 16000)
        write_wav(str(ev / f"{i}.wav"), sine_audio(1.5, 880.0), 16000)
    with open(bg / "corrupt.wav", "wb") as f:
        f.write(b"not a wav file at all")
    assert fad.score(str(bg), str(ev)) == -1
    assert fad.score(str(bg), str(ev), device_stats=True) == -1


def test_preprocessing_error_skips_file_not_batch(fad, sine_audio):
    """In-batch preprocessing failures skip only the file (fad.py:400-403)."""
    good = sine_audio(1.5, 440.0)
    bad = sine_audio(0.2, 440.0)  # < 1 patch -> per-file error, swallowed
    out = fad.get_embeddings([bad, good, bad], 16000)
    assert out.shape == (1, 128)


def test_all_failed_returns_empty(fad, sine_audio):
    # <0.96 s -> zero patches per file (not an error); zero total rows drives
    # score()'s empty-set -1 sentinel exactly like the reference's len()==0
    # check (fad.py:640-645).
    out = fad.get_embeddings([sine_audio(0.2, 440.0)], 16000)
    assert len(out) == 0
    assert out.shape[-1] == 128


class TestHBMScale:
    """hbm_batch_scale: the default batches divide 2x per halving of the
    device memory limit below what they need (_KNEE_HBM_BYTES; VERDICT r3
    weak #7 — no graceful degradation before)."""

    @pytest.fixture(autouse=True)
    def _fresh_cache(self):
        # hbm_batch_scale is lru_cached (memory_stats is a backend RPC);
        # clear around each monkeypatched probe.
        from frechet_audio_distance_exported_tpu import pipeline as pl

        pl.hbm_batch_scale.cache_clear()
        yield
        pl.hbm_batch_scale.cache_clear()

    def test_noop_without_limit(self, monkeypatch):
        from frechet_audio_distance_exported_tpu import pipeline as pl

        monkeypatch.setattr(pl, "_device_hbm_bytes", lambda: None)
        assert pl.hbm_batch_scale() == 1
        assert pl.pann_frame_cap() == pl.PANN_MAX_FRAMES

    def test_noop_at_measurement_hbm(self, monkeypatch):
        from frechet_audio_distance_exported_tpu import pipeline as pl

        monkeypatch.setattr(pl, "_device_hbm_bytes", lambda: pl._KNEE_HBM_BYTES)
        assert pl.hbm_batch_scale() == 1
        monkeypatch.setattr(pl, "_device_hbm_bytes", lambda: 60 * 2**30)
        pl.hbm_batch_scale.cache_clear()
        assert pl.hbm_batch_scale() == 1

    # gib: the device limit as a fraction of _KNEE_HBM_BYTES, in 16ths.
    @pytest.mark.parametrize("gib,expect", [(8, 2), (4, 4), (2, 8), (1, 16), (0.25, 16)])
    def test_divides_per_halving(self, monkeypatch, gib, expect):
        from frechet_audio_distance_exported_tpu import pipeline as pl

        monkeypatch.setattr(
            pl, "_device_hbm_bytes", lambda: int(gib / 16 * pl._KNEE_HBM_BYTES)
        )
        assert pl.hbm_batch_scale() == expect
        assert pl.pann_frame_cap() == pl.PANN_MAX_FRAMES // expect

    def test_default_file_batch_scales(self, monkeypatch):
        from frechet_audio_distance_exported_tpu import pipeline as pl

        monkeypatch.setattr(pl, "_device_hbm_bytes", lambda: pl._KNEE_HBM_BYTES // 4)
        p = pl.EmbeddingPipeline("vggish", params={})
        # The default is 32; at a quarter of the knee the divisor is 4 -> 8.
        assert p.file_batch == 8

    def test_explicit_file_batch_unscaled(self, monkeypatch):
        from frechet_audio_distance_exported_tpu import pipeline as pl

        monkeypatch.setattr(pl, "_device_hbm_bytes", lambda: 4 * 2**30)
        p = pl.EmbeddingPipeline("vggish", params={}, file_batch=64)
        assert p.file_batch == 64


def test_bucket_batch_never_exceeds_cap():
    """Rounding a trailing chunk up to a power of two past a non-power-of-two
    cap would run a program up to ~2x the activation footprint the cap was
    fitted to — an OOM risk at the measured HBM knees (review r5)."""
    from frechet_audio_distance_exported_tpu import pipeline as pl

    assert pl.bucket_batch(33, 43) == 43   # would have been 64
    assert pl.bucket_batch(9, 10) == 10    # would have been 16
    assert pl.bucket_batch(8, 43) == 8     # power of two under cap: unchanged
    assert pl.bucket_batch(50, 43) == 43   # over cap clamps (pre-existing)
    assert pl.bucket_batch(1, 43) == 1
    for n in range(1, 130):
        for cap in (1, 2, 10, 43, 128):
            assert pl.bucket_batch(n, cap) <= cap
