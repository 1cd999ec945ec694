"""Public API tests: mock-math tier + end-to-end scoring with random weights
(mirrors the reference's MockFAD tier, tests/test_basic.py:128-190, plus its
end-to-end sine-dir FAD tests)."""

import os

import numpy as np
import pytest

from frechet_audio_distance_exported_tpu import FrechetAudioDistance
from frechet_audio_distance_exported_tpu.fad import VALID_MODELS
from frechet_audio_distance_exported_tpu.utils.audio_io import write_wav


class MockFAD(FrechetAudioDistance):
    """Math-only instance: skips weight loading (the reference's only 'fake
    backend', tests/test_basic.py:136-141)."""

    def _load_model(self):
        pass


@pytest.fixture
def mock_fad():
    return MockFAD.__new__(MockFAD)


class TestMath:
    def test_frechet_distance_zero_for_identical(self, mock_fad):
        rng = np.random.default_rng(0)
        x = rng.standard_normal((100, 16))
        mu, sigma = mock_fad.calculate_embd_statistics(x)
        assert abs(mock_fad.calculate_frechet_distance(mu, sigma, mu, sigma)) < 1e-8

    def test_frechet_distance_positive_for_shifted(self, mock_fad):
        rng = np.random.default_rng(1)
        x = rng.standard_normal((100, 16))
        mu, sigma = mock_fad.calculate_embd_statistics(x)
        d = mock_fad.calculate_frechet_distance(mu, sigma, mu + 2.0, sigma)
        assert d > 0

    def test_statistics_shapes(self, mock_fad):
        x = np.random.default_rng(2).standard_normal((50, 8))
        mu, sigma = mock_fad.calculate_embd_statistics(x)
        assert mu.shape == (8,)
        assert sigma.shape == (8, 8)

    def test_statistics_accepts_list(self, mock_fad):
        x = [np.ones(4), np.zeros(4)]
        mu, sigma = mock_fad.calculate_embd_statistics(x)
        np.testing.assert_allclose(mu, 0.5)


class TestConstruction:
    def test_invalid_model_raises(self):
        with pytest.raises(ValueError, match="Unknown model"):
            FrechetAudioDistance(model_name="bogus")

    def test_wrong_sample_rate_raises(self):
        with pytest.raises(ValueError, match="requires sample_rate"):
            FrechetAudioDistance(model_name="vggish", sample_rate=22050)

    def test_valid_models_registry(self):
        assert set(VALID_MODELS) == {
            "vggish", "pann-8k", "pann-16k", "pann-32k",
            "encodec-24k", "encodec-48k", "clap",
        }
        assert VALID_MODELS["vggish"]["embedding_dim"] == 128
        assert VALID_MODELS["pann-16k"]["embedding_dim"] == 2048
        assert VALID_MODELS["encodec-24k"]["channels"] == 1
        assert VALID_MODELS["encodec-48k"]["channels"] == 2
        assert VALID_MODELS["clap"]["embedding_dim"] == 512

    def test_missing_weights_raise(self, tmp_path):
        with pytest.raises(FileNotFoundError, match="Weight bundle not found"):
            FrechetAudioDistance(ckpt_dir=str(tmp_path), model_name="vggish")


def _write_sine_dir(path, freqs, duration, sr):
    os.makedirs(path, exist_ok=True)
    for i, f in enumerate(freqs):
        t = np.linspace(0, duration, int(sr * duration), dtype=np.float32)
        write_wav(os.path.join(path, f"{i}.wav"), (np.sin(2 * np.pi * f * t) * 0.5), sr)


class TestEndToEndVGGish:
    @pytest.fixture(scope="class")
    def fad(self):
        return FrechetAudioDistance(model_name="vggish", weights="random")

    def test_score_positive_and_symmetricish(self, fad, tmp_path_factory):
        bg = str(tmp_path_factory.mktemp("bg"))
        ev = str(tmp_path_factory.mktemp("ev"))
        _write_sine_dir(bg, [440, 445, 450], 2.0, 16000)
        _write_sine_dir(ev, [880, 885, 890], 2.0, 16000)
        score = fad.score(bg, ev)
        assert np.isfinite(score) and score > 0

    def test_score_identical_dirs_zero(self, fad, tmp_path_factory):
        bg = str(tmp_path_factory.mktemp("bg2"))
        _write_sine_dir(bg, [440, 550, 660], 2.0, 16000)
        assert abs(fad.score(bg, bg)) < 1e-3

    def test_score_empty_dir_sentinel(self, fad, tmp_path_factory):
        bg = str(tmp_path_factory.mktemp("bge"))
        ev = str(tmp_path_factory.mktemp("eve"))
        _write_sine_dir(ev, [440], 2.0, 16000)
        assert fad.score(bg, ev) == -1

    def test_embeddings_rows_are_patches(self, fad, sine_audio):
        out = fad.get_embeddings([sine_audio(2.0, 440.0), sine_audio(3.0, 880.0)], 16000)
        assert out.shape == (5, 128)  # 2 + 3 patches

    def test_short_audio_skipped(self, fad, sine_audio):
        """<0.96 s files produce zero patches -> skipped like the reference."""
        out = fad.get_embeddings([sine_audio(0.5, 440.0), sine_audio(1.0, 440.0)], 16000)
        assert out.shape == (1, 128)

    def test_single_embedding_hook(self, fad, sine_audio):
        # 2.0 s -> 198 frames -> 2 complete patches (like the reference).
        out = fad._get_embedding_for_audio(sine_audio(2.0, 440.0))
        assert out.shape == (2, 128)
        # <0.96 s -> zero patches -> empty [0, 128], matching the reference
        # hook (waveform_to_examples yields zero patches, not an error).
        out = fad._get_embedding_for_audio(sine_audio(0.1, 440.0))
        assert out.shape == (0, 128)

    def test_embedding_caching(self, fad, tmp_path_factory):
        bg = str(tmp_path_factory.mktemp("bgc"))
        ev = str(tmp_path_factory.mktemp("evc"))
        _write_sine_dir(bg, [440, 450], 2.0, 16000)
        _write_sine_dir(ev, [880, 890], 2.0, 16000)
        cache_dir = str(tmp_path_factory.mktemp("cache"))
        cache = os.path.join(cache_dir, "sub", "bg.npy")
        s1 = fad.score(bg, ev, background_embds_path=cache)
        assert os.path.exists(cache)
        s2 = fad.score(bg, ev, background_embds_path=cache)
        assert s1 == pytest.approx(s2, abs=1e-10)

    def test_embedding_cache_bare_filename(self, fad, tmp_path_factory, monkeypatch):
        """A cache path with no directory component must work — dirname('')
        fed to os.makedirs raised and the -1 sentinel swallowed it."""
        bg = str(tmp_path_factory.mktemp("bgf"))
        ev = str(tmp_path_factory.mktemp("evf"))
        _write_sine_dir(bg, [440], 2.0, 16000)
        _write_sine_dir(ev, [880], 2.0, 16000)
        monkeypatch.chdir(tmp_path_factory.mktemp("cwd"))
        s = fad.score(bg, ev, background_embds_path="bg_embds.npy")
        assert s != -1 and os.path.exists("bg_embds.npy")

    def test_subclass_hooks_see_every_score(self, tmp_path_factory):
        """The low-rank fast path must stand down when a subclass overrides
        the reference-API statistic/distance hooks."""
        from frechet_audio_distance_exported_tpu import FrechetAudioDistance

        calls = []

        class Hooked(FrechetAudioDistance):
            def calculate_frechet_distance(self, mu1, s1, mu2, s2, eps=1e-6):
                calls.append(1)
                return super().calculate_frechet_distance(mu1, s1, mu2, s2, eps)

        # PANN: d=2048 >> n, the regime the fast path normally takes.
        hooked = Hooked(model_name="pann-16k", weights="random")
        bg = str(tmp_path_factory.mktemp("bgh"))
        ev = str(tmp_path_factory.mktemp("evh"))
        _write_sine_dir(bg, [440, 450], 2.0, 16000)
        _write_sine_dir(ev, [880, 890], 2.0, 16000)
        s = hooked.score(bg, ev)
        assert s != -1 and calls, "override was bypassed"

        # device_stats=True epilogue must route through the hook too
        # (review r5: it used to inline the dispatch and skip overrides).
        calls.clear()
        s2 = hooked.score(bg, ev, device_stats=True)
        assert s2 != -1 and calls, "device_stats epilogue bypassed the override"

    def test_warmup_compiles_device_stats_programs(self, tmp_path_factory):
        """warmup() must pre-compile the fused STATS step too — it is a
        different jit program from the embedding step (init and update
        variants), and a serving deployment using score(device_stats=True)
        would otherwise pay the compile on its first real request
        (review r5)."""
        from frechet_audio_distance_exported_tpu import FrechetAudioDistance
        from frechet_audio_distance_exported_tpu import pipeline as pl

        fad = FrechetAudioDistance(model_name="vggish", weights="random")
        before = pl._fused_vggish_stats_step._cache_size()
        fad.warmup(durations=(1.0,), num_files=2)
        after = pl._fused_vggish_stats_step._cache_size()
        # (init + update variants) x (float32 wave + int16 wire) — PCM16
        # corpora ship int16, a different jit key (review r5).
        assert after >= before + 4, (before, after)

    def test_batching_invariance(self, fad, sine_audio):
        """Embeddings are identical whether files go through together or alone
        (the pipeline's bucketing must not change numerics)."""
        a = sine_audio(2.0, 440.0)
        b = sine_audio(4.3, 660.0)
        joint = fad.get_embeddings([a, b], 16000)
        solo = np.concatenate(
            [fad.get_embeddings([a], 16000), fad.get_embeddings([b], 16000)], axis=0
        )
        np.testing.assert_allclose(joint, solo, rtol=1e-5, atol=1e-5)


class TestEndToEndPANN:
    @pytest.fixture(scope="class")
    def fad(self):
        return FrechetAudioDistance(model_name="pann-16k", weights="random")

    def test_score_and_identical(self, fad, tmp_path_factory):
        bg = str(tmp_path_factory.mktemp("bg"))
        ev = str(tmp_path_factory.mktemp("ev"))
        _write_sine_dir(bg, [440, 445, 450], 1.5, 16000)
        _write_sine_dir(ev, [880, 885, 890], 1.5, 16000)
        s = fad.score(bg, ev)
        assert np.isfinite(s) and s > 0
        assert abs(fad.score(bg, bg)) < 1e-3

    def test_one_row_per_file(self, fad, sine_audio):
        out = fad.get_embeddings(
            [sine_audio(1.0, 440.0), sine_audio(2.0, 880.0), sine_audio(1.0, 660.0)], 16000
        )
        assert out.shape == (3, 2048)

    def test_mixed_lengths_match_solo(self, fad, sine_audio):
        """Files on different PANN time grids batch correctly."""
        clips = [sine_audio(1.0, 440.0), sine_audio(2.7, 550.0), sine_audio(1.02, 660.0)]
        joint = fad.get_embeddings(clips, 16000)
        solo = np.concatenate([fad.get_embeddings([c], 16000) for c in clips], axis=0)
        np.testing.assert_allclose(joint, solo, rtol=1e-4, atol=1e-4)
