"""Golden tests for the matmul-DFT / mel DSP blocks.

Each JAX matmul formulation is checked against an independent NumPy+FFT
implementation written here from the published definitions (VGGish HTK
frontend per Google's vggish_input math; librosa-style power mel per the
librosa documentation formulas). The VGGish end-to-end frontend is also
checked against the reference package itself (imported with a stubbed
resampy, since only the sr==16000 path is exercised).
"""

import sys
import types

import numpy as np
import pytest

from frechet_audio_distance_exported_tpu.ops import dsp, frontends


def test_windowed_dft_matches_rfft():
    rng = np.random.default_rng(0)
    frames = rng.standard_normal((7, 400)).astype(np.float32)
    win = dsp.periodic_hann(400)
    expected = np.abs(np.fft.rfft(frames * win, 512))
    got = np.asarray(dsp.stft_magnitude(frames, 400, 512))
    np.testing.assert_allclose(got, expected, rtol=1e-4, atol=1e-3)


def test_windowed_dft_power_matches_rfft():
    rng = np.random.default_rng(1)
    frames = rng.standard_normal((5, 1024)).astype(np.float32)
    win = dsp.periodic_hann(1024)
    expected = np.abs(np.fft.rfft(frames * win, 1024)) ** 2
    got = np.asarray(dsp.stft_power(frames, 1024, 1024))
    np.testing.assert_allclose(got, expected, rtol=1e-3, atol=1e-2)


def test_htk_mel_matrix_properties():
    m = dsp.htk_mel_matrix(64, 257, 16000, 125.0, 7500.0)
    assert m.shape == (257, 64)
    assert np.all(m >= 0)
    assert np.all(m[0, :] == 0.0)  # DC bin excluded
    # Triangles should tile the 125-7500 Hz band: interior bins overlapping
    # the band have positive total weight.
    freqs = np.linspace(0, 8000, 257)
    band = (freqs > 400) & (freqs < 7000)
    assert np.all(m[band].sum(axis=1) > 0)


def _slaney_mel_reference(sr, n_fft, n_mels, fmin, fmax):
    """Independent implementation of librosa.filters.mel(htk=False, norm='slaney')."""

    def hz_to_mel(f):
        f = np.atleast_1d(np.asarray(f, dtype=float))
        mels = f / (200.0 / 3)
        log_t = f >= 1000.0
        mels[log_t] = 15.0 + np.log(f[log_t] / 1000.0) / (np.log(6.4) / 27.0)
        return mels

    def mel_to_hz(m):
        m = np.atleast_1d(np.asarray(m, dtype=float))
        f = m * (200.0 / 3)
        log_t = m >= 15.0
        f[log_t] = 1000.0 * np.exp((np.log(6.4) / 27.0) * (m[log_t] - 15.0))
        return f

    fftfreqs = np.linspace(0, sr / 2, 1 + n_fft // 2)
    mel_f = mel_to_hz(np.linspace(hz_to_mel(fmin)[0], hz_to_mel(fmax)[0], n_mels + 2))
    weights = np.zeros((n_mels, len(fftfreqs)))
    fdiff = np.diff(mel_f)
    ramps = np.subtract.outer(mel_f, fftfreqs)
    for i in range(n_mels):
        lower = -ramps[i] / fdiff[i]
        upper = ramps[i + 2] / fdiff[i + 1]
        weights[i] = np.maximum(0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_f[2 : n_mels + 2] - mel_f[:n_mels])
    weights *= enorm[:, np.newaxis]
    return weights


@pytest.mark.parametrize("sr,n_fft,fmin,fmax", [(8000, 256, 50, 4000), (16000, 512, 50, 8000),
                                                 (32000, 1024, 50, 14000), (48000, 1024, 50, 14000)])
def test_slaney_mel_matrix_librosa_parity(sr, n_fft, fmin, fmax):
    ours = dsp.slaney_mel_matrix(sr, n_fft, 64, fmin, fmax)
    ref = _slaney_mel_reference(sr, n_fft, 64, fmin, fmax).T
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-8)


def _numpy_vggish_logmel(data):
    """Independent NumPy version of the VGGish frontend (no resampling)."""
    win, hop, fft = 400, 160, 512
    n_frames = 1 + (len(data) - win) // hop
    frames = np.stack([data[i * hop : i * hop + win] for i in range(n_frames)])
    window = 0.5 - 0.5 * np.cos(2 * np.pi / win * np.arange(win))
    mag = np.abs(np.fft.rfft(frames * window, fft))
    mel = mag @ np.asarray(dsp.htk_mel_matrix(64, 257, 16000, 125.0, 7500.0), dtype=np.float64)
    return np.log(mel + 0.01)


def test_vggish_logmel_batch_matches_numpy(sine_audio):
    audio = sine_audio(2.0, 440.0)
    import jax.numpy as jnp

    n_frames = frontends.vggish_num_frames(len(audio))
    got = np.asarray(frontends.vggish_logmel_batch(jnp.asarray(audio)[None], n_frames)[0])
    expected = _numpy_vggish_logmel(audio.astype(np.float64))
    # float32 matmul-DFT vs float64 FFT: tiny absolute noise at the log floor.
    np.testing.assert_allclose(got, expected, rtol=1e-3, atol=3e-3)


def test_vggish_frontend_matches_reference_package(sine_audio):
    """End-to-end parity with the actual reference code (sr==16000 path only,
    resampy stubbed since it is never called)."""
    if "resampy" not in sys.modules:
        stub = types.ModuleType("resampy")

        def _no_resample(*a, **k):
            raise RuntimeError("resampy stub should not be called at sr=16000")

        stub.resample = _no_resample
        sys.modules["resampy"] = stub
    try:
        import importlib.util

        spec = importlib.util.spec_from_file_location(
            "ref_vggish_module",
            "/root/reference/frechet_audio_distance_exported/models/vggish.py",
        )
        ref_vggish = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(ref_vggish)
        ref_waveform_to_examples = ref_vggish.waveform_to_examples
    except Exception as e:  # pragma: no cover
        pytest.skip(f"reference package unavailable: {e}")
    audio = sine_audio(3.3, 880.0)
    ref = ref_waveform_to_examples(audio, 16000, return_tensor=False)
    ours = frontends.waveform_to_examples(audio, 16000, return_tensor=False)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, np.asarray(ref), rtol=1e-3, atol=3e-3)


def _numpy_pann_logmel(audio, sr):
    cfg = frontends.PANN_CONFIGS[sr]
    n_fft, hop = cfg["window_size"], cfg["hop_size"]
    padded = np.pad(audio, n_fft // 2, mode="reflect")
    n_frames = 1 + len(audio) // hop
    frames = np.stack([padded[i * hop : i * hop + n_fft] for i in range(n_frames)])
    window = 0.5 - 0.5 * np.cos(2 * np.pi / n_fft * np.arange(n_fft))
    power = np.abs(np.fft.rfft(frames * window, n_fft)) ** 2
    mel = power @ _slaney_mel_reference(sr, n_fft, 64, cfg["fmin"], cfg["fmax"]).T
    return 10.0 * np.log10(np.maximum(mel, 1e-10))


@pytest.mark.parametrize("sr", [8000, 16000, 32000])
def test_pann_logmel_matches_numpy(sr, sine_audio):
    audio = sine_audio(1.7, 440.0, sample_rate=sr)
    got = frontends.waveform_to_logmel(audio, sr, target_sample_rate=sr, return_tensor=False)
    expected = _numpy_pann_logmel(audio.astype(np.float64), sr)
    assert got.shape == expected.shape
    # dB scale: absolute tolerance. The reference's own librosa-vs-torchlibrosa
    # parity bar is 0.5 dB max (verify_pann.py:145-147); float32-vs-float64
    # noise near the -100 dB floor stays well inside it.
    np.testing.assert_allclose(got, expected, rtol=0, atol=0.5)


def test_pann_valid_time_grid():
    # time = 32k - 24 grid (reference fad.py:41-66)
    assert frontends.pann_valid_time(8) == 8
    assert frontends.pann_valid_time(9) == 40
    assert frontends.pann_valid_time(40) == 40
    assert frontends.pann_valid_time(41) == 72
    assert frontends.pann_valid_time(104) == 104
    for t in [1, 17, 100, 313, 1001]:
        v = frontends.pann_valid_time(t)
        assert v >= t and (v + 24) % 32 == 0


def test_clap_quantization_matches_reference_formula(sine_audio):
    audio = sine_audio(0.1, 440.0, 48000)
    expected = (audio * 32767.0).astype(np.int16).astype(np.float32) / 32767.0
    got = np.asarray(frontends.clap_quantize(audio))
    # XLA folds /32767 into a reciprocal multiply: allow 1 ulp.
    np.testing.assert_allclose(got, expected, rtol=0, atol=2e-7)


def test_vggish_frontend_matches_committed_golden(sine_audio):
    """Golden array captured once from the reference package (tests/goldens/),
    so frontend parity is checked even without /root/reference mounted."""
    import os

    golden_path = os.path.join(os.path.dirname(__file__), "goldens",
                               "vggish_patches_sine440_3s.npy")
    golden = np.load(golden_path)
    audio = sine_audio(3.0, 440.0)
    ours = frontends.waveform_to_examples(audio, 16000, return_tensor=False)
    assert ours.shape == golden.shape
    np.testing.assert_allclose(ours, golden, rtol=1e-3, atol=3e-3)


def test_strided_stft_matches_gather_framing():
    """The gather-free STFT equals the direct framed formulation."""
    import jax.numpy as jnp

    from frechet_audio_distance_exported_tpu.ops import dsp

    wave = (np.random.default_rng(2).standard_normal((3, 20000)) * 0.5).astype(np.float32)
    num_frames = 1 + (20000 - 400) // 160
    frames = dsp.frame_signal(jnp.asarray(wave), num_frames, 400, 160)
    ref = np.asarray(dsp.stft_power(frames, 400, 512))
    got = np.asarray(dsp.stft_power_strided(jnp.asarray(wave), num_frames, 400, 512, 160))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_strided_stft_single_matmul_matches_chunk_sum():
    """single_matmul=True (VGGish's lane-concat framing) equals the chunk-sum
    form up to f32 K-accumulation order — a wiring bug (wrong chunk order /
    wrong zero-pad rows) would be O(1) wrong, not O(1e-5)."""
    import jax.numpy as jnp

    from frechet_audio_distance_exported_tpu.ops import dsp

    wave = (np.random.default_rng(3).standard_normal((2, 20000)) * 0.5).astype(np.float32)
    for win, fft, hop in [(400, 512, 160), (512, 512, 160), (1024, 1024, 480)]:
        num_frames = 1 + (20000 - win) // hop
        a = np.asarray(dsp.stft_power_strided(jnp.asarray(wave), num_frames, win, fft, hop))
        b = np.asarray(
            dsp.stft_power_strided(jnp.asarray(wave), num_frames, win, fft, hop,
                                   single_matmul=True)
        )
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-4)
