"""Batched, jittable audio frontends for every model family.

Reference behavior being matched (file:line cites into /root/reference):
- VGGish: mono -> 16 kHz -> 25ms/10ms periodic-Hann STFT *magnitude* (512-pt
  rFFT) -> HTK mel (64 bins, 125-7500 Hz, DC zeroed) -> log(mel + 0.01) ->
  non-overlapping [96, 64] patches, incomplete tail dropped
  (models/vggish.py:230-279).
- PANN/CLAP: mono -> target SR -> librosa-style center/reflect STFT power ->
  Slaney mel -> 10*log10(max(mel, 1e-10)) (models/pann.py:68-145); CLAP adds
  int16 quantization before the mel (models/clap.py:70-72) and requires the
  waveform zero-padded to 10 s *before* the mel (fad.py:354-359).
- Encodec: channel convert + resample + zero-pad to exactly 10 s raw waveform
  (models/encodec.py:45-169); no spectral frontend.

Design: the host only decodes/resamples and applies the tiny reflect pad;
everything else runs as one jitted batched function with static shapes.
Per-file frame counts enter as *masks*, never as dynamic shapes.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from . import dsp
from .resample import resample
from ..config import exactness_forced, matmul_precision


# ---------------------------------------------------------------------------
# VGGish frontend constants (reference: models/vggish.py:17-33)
# ---------------------------------------------------------------------------

VGGISH_SAMPLE_RATE = 16000
VGGISH_WINDOW = 400  # 25 ms
VGGISH_HOP = 160  # 10 ms
VGGISH_FFT = 512  # 2**ceil(log2(400))
VGGISH_MEL_BINS = 64
VGGISH_MEL_MIN_HZ = 125.0
VGGISH_MEL_MAX_HZ = 7500.0
VGGISH_LOG_OFFSET = 0.01
VGGISH_PATCH_FRAMES = 96  # 0.96 s window and hop -> non-overlapping patches

# PANN frontend configs (reference: models/pann.py:25-59). The 48 kHz entry is
# the CLAP mel config.
PANN_CONFIGS = {
    8000: {"sample_rate": 8000, "window_size": 256, "hop_size": 80, "mel_bins": 64, "fmin": 50, "fmax": 4000},
    16000: {"sample_rate": 16000, "window_size": 512, "hop_size": 160, "mel_bins": 64, "fmin": 50, "fmax": 8000},
    32000: {"sample_rate": 32000, "window_size": 1024, "hop_size": 320, "mel_bins": 64, "fmin": 50, "fmax": 14000},
    48000: {"sample_rate": 48000, "window_size": 1024, "hop_size": 480, "mel_bins": 64, "fmin": 50, "fmax": 14000},
}

# CLAP constants (reference: models/clap.py:31-34, fad.py:38)
CLAP_SAMPLE_RATE = 48000
CLAP_MAX_AUDIO_SECONDS = 10
CLAP_MAX_SAMPLES = CLAP_MAX_AUDIO_SECONDS * CLAP_SAMPLE_RATE  # 480000
CLAP_TIME_FRAMES = 1001

# Encodec constants (reference: models/encodec.py:16-42)
ENCODEC_MAX_AUDIO_SECONDS = 10
ENCODEC_CONFIGS = {
    24000: {
        "sample_rate": 24000,
        "channels": 1,
        "embedding_dim": 128,
        "hop_length": 320,
        "max_samples": ENCODEC_MAX_AUDIO_SECONDS * 24000,
    },
    48000: {
        "sample_rate": 48000,
        "channels": 2,
        "embedding_dim": 128,
        "hop_length": 320,
        "max_samples": ENCODEC_MAX_AUDIO_SECONDS * 48000,
    },
}


# ---------------------------------------------------------------------------
# Frame-count arithmetic (shape planning happens on host)
# ---------------------------------------------------------------------------


def vggish_num_frames(num_samples: int) -> int:
    """Frames of the uncentered VGGish STFT (reference: models/vggish.py:114)."""
    if num_samples < VGGISH_WINDOW:
        return 0
    return 1 + (num_samples - VGGISH_WINDOW) // VGGISH_HOP


def vggish_num_patches(num_samples: int) -> int:
    """Complete non-overlapping 96-frame patches (tail dropped,
    reference: models/vggish.py:263-271)."""
    return vggish_num_frames(num_samples) // VGGISH_PATCH_FRAMES


def pann_num_frames(num_samples: int, hop_size: int) -> int:
    """librosa center=True frame count: 1 + floor(S / hop)."""
    return 1 + num_samples // hop_size


def pann_valid_time(time: int) -> int:
    """Smallest t >= time with t = 32k - 24 (the exported-PANN time grid the
    reference zero-pads to; reference: fad.py:41-66). That padding is part of
    the numerics: zero log-mel rows flow through global pooling."""
    k = (time + 24 + 31) // 32
    valid = 32 * k - 24
    if valid < time:  # unreachable for time >= 1; kept to mirror the
        valid += 32   # reference's own safety bump (fad.py:58-59)
    return valid


# ---------------------------------------------------------------------------
# VGGish: batched log-mel and patches
# ---------------------------------------------------------------------------


def dequant_i16(wave: jnp.ndarray, full_scale: float = 32768.0) -> jnp.ndarray:
    """int16-shipped waveforms -> float32 on device.

    PCM16-exact audio is transferred as int16 (half the host->device bytes)
    and dequantized here, inside the jitted frontend, losslessly. float32 input
    passes through; jit specializes per dtype, so this is trace-time only.

    Division (not reciprocal multiply): CLAP's grid is k/32767 and 1/32767
    is not a power of two — only k / full_scale reproduces the host float32
    quantization bit-for-bit.
    """
    if wave.dtype == jnp.int16:
        return wave.astype(jnp.float32) / full_scale
    return wave


def vggish_logmel_batch(
    wave: jnp.ndarray, num_frames: int, impl: str = "xla"
) -> jnp.ndarray:
    """[B, S] float32 (or PCM16-exact int16) @16 kHz -> [B, num_frames, 64]
    log-mel (HTK, magnitude).

    Exact math of the reference frontend (models/vggish.py:193-227) recast as
    two matmuls. Frames are the uncentered 400/160 grid; rows beyond a
    file's true frame count are defined but must be masked by the caller.

    ``impl``: 'xla' keeps the chunk-sum DFT accumulation order (the
    host-facing/golden/parity route); 'auto' (the device pipeline) takes one
    lane-concatenated DFT matmul instead, unless the user forced exact
    numerics (config.exactness_forced). The env knobs are resolved HERE, at
    call time, and folded into the jit key as statics, so flipping them
    mid-process retraces instead of reusing a stale traced branch.
    """
    if impl not in ("auto", "xla"):
        raise ValueError(f"impl must be 'auto' or 'xla', got {impl!r}")
    return _vggish_logmel_jit(
        wave, num_frames, impl == "auto" and not exactness_forced(),
        matmul_precision(),
    )


@functools.partial(
    jax.jit, static_argnames=("num_frames", "single_matmul", "precision")
)
def _vggish_logmel_jit(
    wave: jnp.ndarray,
    num_frames: int,
    single_matmul: bool,
    precision,
) -> jnp.ndarray:
    wave = dequant_i16(wave)
    mel_mat = jnp.asarray(
        dsp.htk_mel_matrix(
            VGGISH_MEL_BINS, VGGISH_FFT // 2 + 1, VGGISH_SAMPLE_RATE,
            VGGISH_MEL_MIN_HZ, VGGISH_MEL_MAX_HZ,
        )
    )
    # single_matmul: one [B, T, 3*hop] x [3*hop, 2F] DFT product instead of a
    # 3-chunk matmul sum (~7e-6 on this offset-floored log-mel —
    # dsp.stft_spectrum_strided docstring).
    mag = dsp.stft_magnitude_strided(
        wave, num_frames, VGGISH_WINDOW, VGGISH_FFT, VGGISH_HOP,
        single_matmul=single_matmul,
    )
    mel = jnp.matmul(mag, mel_mat, preferred_element_type=jnp.float32, precision=precision)
    return jnp.log(mel + VGGISH_LOG_OFFSET)


def vggish_patches_batch(
    wave: jnp.ndarray, num_patches: int, impl: str = "xla"
) -> jnp.ndarray:
    """[B, S] -> [B, P, 96, 64] non-overlapping log-mel patches."""
    log_mel = vggish_logmel_batch(wave, num_patches * VGGISH_PATCH_FRAMES, impl=impl)
    b = wave.shape[0]
    return log_mel.reshape(b, num_patches, VGGISH_PATCH_FRAMES, VGGISH_MEL_BINS)


# ---------------------------------------------------------------------------
# PANN / CLAP: batched librosa-parity log-mel
# ---------------------------------------------------------------------------


def reflect_pad_host(audio: np.ndarray, n_fft: int) -> np.ndarray:
    """librosa center=True reflect pad (host-side, O(n_fft) work).

    Doing this tiny pad on the host keeps the device frontend independent of
    each file's true length, so arbitrary zero-padded length buckets stay
    numerically exact.
    """
    return np.pad(audio, n_fft // 2, mode="reflect")


def pann_logmel_batch(
    padded_wave: jnp.ndarray,
    target_sample_rate: int,
    num_frames: int,
    n_valid_frames: Optional[jnp.ndarray] = None,
    i16_full_scale: float = 32768.0,
) -> jnp.ndarray:
    """Reflect-padded [B, L] float32 (or int16 on the k/i16_full_scale grid)
    -> [B, num_frames, 64] log-mel (dB).

    ``padded_wave`` rows are reflect_pad_host(x, n_fft) then zero-extended to a
    common bucket length L. Frame t spans padded[t*hop : t*hop + n_fft], which
    reproduces librosa.stft(center=True, pad_mode='reflect')
    (reference: models/pann.py:107-136). Rows >= n_valid_frames[b] are set to
    0.0 — exactly the reference's zero pad of the log-mel onto the PANN time
    grid (reference: fad.py:41-66).

    FAD_TPU_PRECISION is resolved at call time and keyed into the jit as a
    static, so a mid-process flip retraces.
    """
    return _pann_logmel_jit(
        padded_wave, target_sample_rate, num_frames, n_valid_frames,
        i16_full_scale, matmul_precision(),
    )


@functools.partial(
    jax.jit,
    static_argnames=("target_sample_rate", "num_frames", "i16_full_scale", "precision"),
)
def _pann_logmel_jit(
    padded_wave: jnp.ndarray,
    target_sample_rate: int,
    num_frames: int,
    n_valid_frames: Optional[jnp.ndarray],
    i16_full_scale: float,
    precision,
) -> jnp.ndarray:
    padded_wave = dequant_i16(padded_wave, i16_full_scale)
    cfg = PANN_CONFIGS[target_sample_rate]
    n_fft, hop = cfg["window_size"], cfg["hop_size"]
    mel_mat = jnp.asarray(
        dsp.slaney_mel_matrix(target_sample_rate, n_fft, cfg["mel_bins"], cfg["fmin"], cfg["fmax"])
    )
    power = dsp.stft_power_strided(padded_wave, num_frames, n_fft, n_fft, hop)
    mel = jnp.matmul(power, mel_mat, preferred_element_type=jnp.float32, precision=precision)
    log_mel = 10.0 * jnp.log10(jnp.maximum(mel, 1e-10))
    if n_valid_frames is not None:
        frame_ids = jnp.arange(num_frames)[None, :, None]
        log_mel = jnp.where(frame_ids < n_valid_frames[:, None, None], log_mel, 0.0)
    return log_mel


@jax.jit
def clap_quantize(audio: jnp.ndarray) -> jnp.ndarray:
    """int16 round-trip quantization CLAP was trained with
    (reference: models/clap.py:70-72).

    NumPy's float->int16 cast wraps modulo 2^16 for out-of-range values
    (|x| > 1.0, legal in IEEE-float WAVs) while XLA's convert saturates; the
    int32 + modulo formulation reproduces the NumPy/reference semantics.
    """
    q = (audio * 32767.0).astype(jnp.int32)
    q = ((q + 32768) % 65536) - 32768
    return q.astype(jnp.float32) / 32767.0


def clap_logmel_batch(
    padded_wave: jnp.ndarray, i16_full_scale: float = 32767.0
) -> jnp.ndarray:
    """Quantized, reflect-padded [B, 480000 + n_fft] -> [B, 1001, 64].

    The caller must have zero-padded the *waveform* to 480000 samples before
    the reflect pad (reference: fad.py:354-359 — mel of zeros != zeros).
    int16 input dequantizes on CLAP's k/32767 grid (the clap_quantize grid —
    NOT the PCM k/32768 grid pann_logmel_batch defaults to)."""
    return pann_logmel_batch(
        padded_wave, CLAP_SAMPLE_RATE, CLAP_TIME_FRAMES,
        i16_full_scale=i16_full_scale,
    )


# ---------------------------------------------------------------------------
# Reference-compatible single-file helpers (NumPy in, NumPy/JAX out)
# ---------------------------------------------------------------------------


def waveform_to_examples(data: np.ndarray, sample_rate: int, return_tensor: bool = True):
    """VGGish: waveform -> [N, 96, 64] log-mel patches
    (API parity with reference models/vggish.py:230-279).

    return_tensor=True returns a jax.Array shaped [N, 1, 96, 64] (the
    reference returns a torch tensor of the same shape).
    """
    data = np.asarray(data)
    if data.ndim > 1:
        data = np.mean(data, axis=1)
    if sample_rate != VGGISH_SAMPLE_RATE:
        data = resample(data, sample_rate, VGGISH_SAMPLE_RATE)
    num_patches = vggish_num_patches(len(data))
    if num_patches == 0:
        out = np.zeros((0, VGGISH_PATCH_FRAMES, VGGISH_MEL_BINS), dtype=np.float32)
    else:
        need = VGGISH_WINDOW + (num_patches * VGGISH_PATCH_FRAMES - 1) * VGGISH_HOP
        wave = jnp.asarray(data[:need], dtype=jnp.float32)[None, :]
        out = np.asarray(vggish_patches_batch(wave, num_patches)[0])
    if return_tensor:
        return jnp.asarray(out[:, None, :, :], dtype=jnp.float32)
    return out


def waveform_to_logmel(
    audio: np.ndarray,
    sample_rate: int,
    target_sample_rate: int = 16000,
    return_tensor: bool = True,
):
    """PANN: waveform -> log-mel (API parity with reference models/pann.py:68-145).

    return_tensor=True returns a jax.Array [1, 1, T, 64]; else np [T, 64].
    """
    if target_sample_rate not in PANN_CONFIGS:
        raise ValueError(f"target_sample_rate must be one of {list(PANN_CONFIGS.keys())}")
    cfg = PANN_CONFIGS[target_sample_rate]
    audio = np.asarray(audio)
    if audio.ndim > 1:
        audio = np.mean(audio, axis=1)
    if sample_rate != target_sample_rate:
        audio = resample(audio, sample_rate, target_sample_rate)
    audio = audio.astype(np.float32)
    num_frames = pann_num_frames(len(audio), cfg["hop_size"])
    padded = reflect_pad_host(audio, cfg["window_size"])
    log_mel = pann_logmel_batch(jnp.asarray(padded)[None, :], target_sample_rate, num_frames)
    if return_tensor:
        return log_mel[:, None, :, :]
    return np.asarray(log_mel[0])


def preprocess_for_clap(
    audio: np.ndarray,
    sample_rate: int,
    return_tensor: bool = True,
    apply_quantization: bool = True,
):
    """CLAP: mono-mix -> int16 quantization -> 48 kHz log-mel
    (API parity with reference models/clap.py:41-80)."""
    audio = np.asarray(audio)
    if audio.ndim > 1:
        audio = np.mean(audio, axis=1)
    if apply_quantization:
        audio = audio.astype(np.float32)
        audio = (audio * 32767.0).astype(np.int16).astype(np.float32) / 32767.0
    return waveform_to_logmel(
        audio, sample_rate, target_sample_rate=CLAP_SAMPLE_RATE, return_tensor=return_tensor
    )


def pad_audio_to_max_length(audio: np.ndarray, sample_rate: int) -> np.ndarray:
    """Zero-pad waveform to 10 s; raise beyond
    (reference: models/clap.py:83-105)."""
    max_samples = CLAP_MAX_AUDIO_SECONDS * sample_rate
    if len(audio) > max_samples:
        raise ValueError(
            f"Audio too long: {len(audio) / sample_rate:.2f}s > {CLAP_MAX_AUDIO_SECONDS}s max"
        )
    if len(audio) < max_samples:
        audio = np.pad(audio, (0, max_samples - len(audio)), mode="constant")
    return audio


def preprocess_for_encodec(
    audio: np.ndarray,
    sample_rate: int,
    target_sample_rate: int = 24000,
    target_channels: int = 1,
    return_tensor: bool = True,
):
    """Encodec: channel conversion + per-channel resample + [1, C, S] reshape
    (API parity with reference models/encodec.py:45-138)."""
    if target_sample_rate not in ENCODEC_CONFIGS:
        raise ValueError(
            f"Unsupported target sample rate: {target_sample_rate}. "
            f"Must be one of {list(ENCODEC_CONFIGS.keys())}"
        )
    audio = np.asarray(audio)
    if audio.ndim == 1:
        num_channels = 1
    elif audio.ndim == 2:
        num_channels = audio.shape[1]
    else:
        raise ValueError(f"Audio must be 1D or 2D, got shape {audio.shape}")

    if target_channels == 1:
        if num_channels > 1:
            audio = np.mean(audio, axis=1)
    elif target_channels == 2:
        if num_channels == 1:
            if audio.ndim == 1:
                audio = np.column_stack([audio, audio])
            else:
                audio = np.concatenate([audio, audio], axis=1)

    if audio.ndim == 2 and audio.shape[1] != target_channels:
        raise ValueError(
            f"Channel conversion failed. Expected {target_channels} channels, got {audio.shape[1]}"
        )

    if sample_rate != target_sample_rate:
        if audio.ndim == 1:
            audio = resample(audio, sample_rate, target_sample_rate)
        else:
            audio = np.column_stack(
                [resample(audio[:, c], sample_rate, target_sample_rate) for c in range(audio.shape[1])]
            )

    audio = audio.astype(np.float32)
    audio = audio.reshape(1, -1) if audio.ndim == 1 else audio.T  # [C, S]
    if return_tensor:
        return jnp.asarray(audio)[None, :, :]  # [1, C, S]
    return audio


def pad_to_fixed_length(x, target_sample_rate: int):
    """Zero-pad [B, C, S] waveform to exactly 10 s; raise beyond
    (reference: models/encodec.py:141-169)."""
    config = ENCODEC_CONFIGS[target_sample_rate]
    max_samples = config["max_samples"]
    samples = x.shape[-1]
    if samples > max_samples:
        raise ValueError(
            f"Audio too long: {samples} samples > {max_samples} max samples "
            f"({ENCODEC_MAX_AUDIO_SECONDS} seconds at {target_sample_rate}Hz). "
            f"Please split audio into shorter segments."
        )
    if samples < max_samples:
        pad = [(0, 0)] * (x.ndim - 1) + [(0, max_samples - samples)]
        x = jnp.pad(jnp.asarray(x), pad) if isinstance(x, jax.Array) else np.pad(x, pad)
    return x


def pad_to_valid_encodec_length(x):
    """DEPRECATED in the reference too: pad to a multiple of hop 320
    (reference: models/encodec.py:172-194)."""
    hop_length = 320
    samples = x.shape[-1]
    remainder = samples % hop_length
    if remainder != 0:
        pad = [(0, 0)] * (x.ndim - 1) + [(0, hop_length - remainder)]
        x = jnp.pad(jnp.asarray(x), pad) if isinstance(x, jax.Array) else np.pad(x, pad)
    return x
