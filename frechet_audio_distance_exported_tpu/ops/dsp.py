"""Core DSP building blocks, formulated as dense matmuls.

The reference computes STFTs with np.fft / librosa on the host
(reference: models/vggish.py:125-141, models/pann.py:107-118). On an
accelerator the formulation here is a *matmul-DFT*: the analysis window is folded into a
dense [window, n_bins] cos/sin matrix so the whole frontend becomes
framing (gather) -> one [T, W] x [W, 2F] matmul -> elementwise power/magnitude
-> one [T, F] x [F, M] mel matmul -> log. Every FLOP is a dense matrix
product and XLA fuses the elementwise stages around the matmuls.

Host-side constant builders (float64 NumPy, cached per config):
- periodic Hann window                 (reference: models/vggish.py:120-122)
- windowed rFFT cos/sin matrices
- HTK mel matrix, DC bin zeroed        (reference: models/vggish.py:150-190)
- Slaney mel matrix (librosa parity)   (reference: models/pann.py:121-127)
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..config import matmul_precision

# ---------------------------------------------------------------------------
# Windows
# ---------------------------------------------------------------------------


def periodic_hann(window_length: int) -> np.ndarray:
    """Periodic Hann window: 0.5 - 0.5*cos(2*pi*n/N).

    Both the VGGish frontend (reference: models/vggish.py:120-122) and
    librosa's default 'hann' (fftbins=True) use the periodic variant.
    """
    return 0.5 - 0.5 * np.cos(2.0 * np.pi / window_length * np.arange(window_length))


# ---------------------------------------------------------------------------
# Matmul-DFT matrices
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=16)
def windowed_dft_matrices(window_length: int, fft_length: int):
    """[W, F] cos / sin matrices with the periodic-Hann window folded in.

    For frames x[.., W]:  re = x @ C, im = x @ S  equals
    np.fft.rfft(x * hann, fft_length). F = fft_length//2 + 1.
    """
    w = periodic_hann(window_length)
    n = np.arange(window_length)[:, None]
    k = np.arange(fft_length // 2 + 1)[None, :]
    ang = 2.0 * np.pi * n * k / fft_length
    cos_m = (w[:, None] * np.cos(ang)).astype(np.float32)
    sin_m = (-w[:, None] * np.sin(ang)).astype(np.float32)
    return cos_m, sin_m


# ---------------------------------------------------------------------------
# Mel filterbanks
# ---------------------------------------------------------------------------

_MEL_BREAK_FREQUENCY_HERTZ = 700.0
_MEL_HIGH_FREQUENCY_Q = 1127.0


def _hertz_to_mel_htk(frequencies_hertz):
    return _MEL_HIGH_FREQUENCY_Q * np.log(1.0 + (frequencies_hertz / _MEL_BREAK_FREQUENCY_HERTZ))


@functools.lru_cache(maxsize=16)
def htk_mel_matrix(
    num_mel_bins: int,
    num_spectrogram_bins: int,
    audio_sample_rate: int,
    lower_edge_hertz: float,
    upper_edge_hertz: float,
) -> np.ndarray:
    """[F, M] HTK-style triangular mel matrix with the DC bin zeroed.

    Matches the Google VGGish frontend (reference: models/vggish.py:150-190):
    unnormalized triangles on the HTK mel scale, spectrogram DC bin excluded.
    """
    nyquist = audio_sample_rate / 2.0
    if lower_edge_hertz < 0.0:
        raise ValueError(f"lower_edge_hertz {lower_edge_hertz} must be >= 0")
    if lower_edge_hertz >= upper_edge_hertz:
        raise ValueError(f"lower_edge_hertz {lower_edge_hertz} >= upper_edge_hertz {upper_edge_hertz}")
    if upper_edge_hertz > nyquist:
        raise ValueError(f"upper_edge_hertz {upper_edge_hertz} is greater than Nyquist {nyquist}")

    bins_hz = np.linspace(0.0, nyquist, num_spectrogram_bins)
    bins_mel = _hertz_to_mel_htk(bins_hz)
    edges_mel = np.linspace(
        _hertz_to_mel_htk(lower_edge_hertz), _hertz_to_mel_htk(upper_edge_hertz), num_mel_bins + 2
    )
    lower = edges_mel[:-2][None, :]
    center = edges_mel[1:-1][None, :]
    upper = edges_mel[2:][None, :]
    lower_slope = (bins_mel[:, None] - lower) / (center - lower)
    upper_slope = (upper - bins_mel[:, None]) / (upper - center)
    weights = np.maximum(0.0, np.minimum(lower_slope, upper_slope))
    weights[0, :] = 0.0  # HTK excludes the spectrogram DC bin
    return weights.astype(np.float32)


def _hz_to_mel_slaney(frequencies):
    frequencies = np.asanyarray(frequencies, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (frequencies - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = frequencies >= min_log_hz
    mels = np.where(
        log_region,
        min_log_mel + np.log(np.maximum(frequencies, min_log_hz) / min_log_hz) / logstep,
        mels,
    )
    return mels


def _mel_to_hz_slaney(mels):
    mels = np.asanyarray(mels, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = mels >= min_log_mel
    freqs = np.where(log_region, min_log_hz * np.exp(logstep * (mels - min_log_mel)), freqs)
    return freqs


@functools.lru_cache(maxsize=16)
def slaney_mel_matrix(
    sample_rate: int, n_fft: int, n_mels: int, fmin: float, fmax: float
) -> np.ndarray:
    """[F, M] Slaney-scale, Slaney-normalized mel matrix (librosa parity).

    Replicates librosa.filters.mel(htk=False, norm='slaney'), the frontend the
    reference PANN/CLAP path uses (reference: models/pann.py:121-127).
    Returned transposed ([F, M]) so the mel stage is a plain right-matmul.
    """
    fftfreqs = np.linspace(0.0, sample_rate / 2.0, 1 + n_fft // 2)
    mel_f = _mel_to_hz_slaney(
        np.linspace(_hz_to_mel_slaney(fmin), _hz_to_mel_slaney(fmax), n_mels + 2)
    )
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1][:, None]
    upper = ramps[2:] / fdiff[1:][:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_f[2 : n_mels + 2] - mel_f[:n_mels])
    weights *= enorm[:, None]
    return weights.T.astype(np.float32)


# ---------------------------------------------------------------------------
# Framing + spectrogram (jit-able)
# ---------------------------------------------------------------------------


def frame_signal(x: jnp.ndarray, num_frames: int, window_length: int, hop_length: int) -> jnp.ndarray:
    """Frame [..., S] -> [..., num_frames, window_length] via a static gather.

    Mirrors the strided framing in the reference (models/vggish.py:102-117)
    but with static shapes so XLA can tile it.
    """
    idx = np.arange(num_frames)[:, None] * hop_length + np.arange(window_length)[None, :]
    return x[..., idx]


@functools.lru_cache(maxsize=16)
def chunked_dft_matrices(window_length: int, fft_length: int, hop_length: int):
    """The windowed DFT matrix split into hop-sized row chunks, zero-padded.

    Enables the gather-free STFT: with X = wave reshaped to hop-sized rows,
      re[t] = sum_m X[t + m] @ C_m,
    i.e. framing becomes shifted views of a non-overlapping reshape and the
    whole STFT is M = ceil(W/hop) dense [T, hop] x [hop, F] matmuls — no
    [T, W] frame materialization, no gather. (The overlap-as-matmul-sum trick
    keeps every FLOP in dense matrix products.)
    """
    cos_m, sin_m = windowed_dft_matrices(window_length, fft_length)
    num_chunks = -(-window_length // hop_length)
    padded = num_chunks * hop_length
    f = fft_length // 2 + 1
    cos_p = np.zeros((padded, f), np.float32)
    sin_p = np.zeros((padded, f), np.float32)
    cos_p[:window_length] = cos_m
    sin_p[:window_length] = sin_m
    return (
        cos_p.reshape(num_chunks, hop_length, f),
        sin_p.reshape(num_chunks, hop_length, f),
    )


@functools.lru_cache(maxsize=16)
def _chunked_dft_cat(window_length: int, fft_length: int, hop_length: int):
    """chunked_dft_matrices with cos|sin concatenated: ([m, hop, 2F], F)."""
    cos_c, sin_c = chunked_dft_matrices(window_length, fft_length, hop_length)
    return np.concatenate([cos_c, sin_c], axis=2), cos_c.shape[2]


def stft_spectrum_strided(
    wave: jnp.ndarray,
    num_frames: int,
    window_length: int,
    fft_length: int,
    hop_length: int,
    single_matmul: bool = False,
):
    """[B, S] -> (re, im) each [B, num_frames, F] without materializing frames.

    Requires S >= (num_frames + ceil(W/hop) - 1) * hop (callers bucket-pad
    anyway); excess samples are ignored.

    Layout choices:
    - cos|sin concatenated column-wise (always on): one [.., hop] x [hop, 2F]
      product per chunk instead of two — halves the LHS reads; per-column
      results are bitwise identical to the split form.
    - ``single_matmul``: the ceil(W/hop) chunks concatenated on the minor
      axis into ONE [B, T, m*hop] operand and a single [m*hop, 2F] matmul,
      instead of summing m separate matmul outputs — XLA does not fuse
      across matmuls, so the chunked sum materializes m [B, T, 2F] f32
      outputs (~1.5 GB at B=256); the frames concat costs one ~0.5 GB
      write. The K-accumulation order changes,
      which is invisible on VGGish's offset-floored log-mel (~7e-6) but moves
      PANN/CLAP's floorless-dB quiet bins by 0.15-0.3 dB on pure-tone
      goldens (most of the reference's own 0.5 dB librosa-parity budget), so
      ONLY the VGGish frontend opts in; PANN/CLAP keep the exact chunk-sum.
    """
    cat_c, nbin = _chunked_dft_cat(window_length, fft_length, hop_length)
    num_chunks = cat_c.shape[0]
    need = (num_frames + num_chunks - 1) * hop_length
    if wave.shape[-1] < need:
        wave = jnp.pad(wave, ((0, 0), (0, need - wave.shape[-1])))
    x = wave[:, :need].reshape(wave.shape[0], num_frames + num_chunks - 1, hop_length)
    if single_matmul:
        frames = jnp.concatenate(
            [x[:, m : m + num_frames] for m in range(num_chunks)], axis=-1
        )  # [B, T, m*hop]: sample order matches cat_c's chunk-major rows
        both = jnp.matmul(
            frames,
            jnp.asarray(cat_c.reshape(num_chunks * hop_length, 2 * nbin)),
            preferred_element_type=jnp.float32,
            precision=matmul_precision(),
        )
    else:
        both = None
        for m in range(num_chunks):
            xm = x[:, m : m + num_frames]
            t = jnp.matmul(xm, jnp.asarray(cat_c[m]), preferred_element_type=jnp.float32,
                           precision=matmul_precision())
            both = t if both is None else both + t
    return both[..., :nbin], both[..., nbin:]


def stft_power_strided(wave, num_frames, window_length, fft_length, hop_length,
                       single_matmul: bool = False):
    re, im = stft_spectrum_strided(wave, num_frames, window_length, fft_length,
                                   hop_length, single_matmul)
    return re * re + im * im


def stft_magnitude_strided(wave, num_frames, window_length, fft_length, hop_length,
                           single_matmul: bool = False):
    return jnp.sqrt(stft_power_strided(wave, num_frames, window_length, fft_length,
                                       hop_length, single_matmul))


def stft_power(frames: jnp.ndarray, window_length: int, fft_length: int) -> jnp.ndarray:
    """|rfft(frames * hann)|^2 via matmul-DFT. frames: [..., T, W] -> [..., T, F]."""
    cos_m, sin_m = windowed_dft_matrices(window_length, fft_length)
    re = jnp.matmul(frames, jnp.asarray(cos_m), preferred_element_type=jnp.float32, precision=matmul_precision())
    im = jnp.matmul(frames, jnp.asarray(sin_m), preferred_element_type=jnp.float32, precision=matmul_precision())
    return re * re + im * im


def stft_magnitude(frames: jnp.ndarray, window_length: int, fft_length: int) -> jnp.ndarray:
    """|rfft(frames * hann)| via matmul-DFT. frames: [..., T, W] -> [..., T, F]."""
    return jnp.sqrt(stft_power(frames, window_length, fft_length))
