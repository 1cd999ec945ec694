"""The XLA paths that replaced the removed fused kernels, against plain
float64 NumPy written here from the published definitions:

- the PANN/CLAP log-mel (librosa center/reflect STFT power -> Slaney mel ->
  10*log10) at every geometry, batched with rows past ``n_valid`` masked to
  0.0, and on a wave shorter than one second;
- the VGGish log-mel (uncentered 400/160 STFT magnitude -> HTK mel with the
  DC bin zeroed -> log(mel + 0.01)) at 96, 296 and 480 frames;
- the CLAP Swin block (LN -> shifted-window attention with relative position
  bias and shift mask -> proj -> residual -> LN -> exact-GELU MLP ->
  residual) at all four stage widths, shifted and unshifted.

Inputs are noise, so every mel bin sits far above float32 rounding.
"""

import numpy as np
import pytest
from scipy.special import erf

from frechet_audio_distance_exported_tpu.models import clap
from frechet_audio_distance_exported_tpu.ops import frontends as fe

# ---------------------------------------------------------------------------
# Log-mel references
# ---------------------------------------------------------------------------


def _hann(n):
    return 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / n)  # periodic


def _slaney_mel(sr, n_fft, n_mels, fmin, fmax):
    """librosa.filters.mel(htk=False, norm='slaney'): [n_fft//2 + 1, n_mels]."""
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    min_log_mel, logstep = min_log_hz / f_sp, np.log(6.4) / 27.0

    def hz_to_mel(f):
        f = np.asarray(f, dtype=np.float64)
        return np.where(f >= min_log_hz, min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep, f / f_sp)

    def mel_to_hz(m):
        return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), f_sp * m)

    freqs = np.arange(n_fft // 2 + 1) * sr / n_fft
    edges = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2))
    w = np.zeros((n_mels, freqs.size))
    for i in range(n_mels):
        lo, mid, hi = edges[i], edges[i + 1], edges[i + 2]
        w[i] = np.maximum(0.0, np.minimum((freqs - lo) / (mid - lo), (hi - freqs) / (hi - mid)))
        w[i] *= 2.0 / (hi - lo)
    return w.T


def _pann_logmel_np(wave, sr):
    """[S] -> [1 + S // hop, 64] dB log-mel (center=True, reflect pad)."""
    cfg = fe.PANN_CONFIGS[sr]
    n_fft, hop = cfg["window_size"], cfg["hop_size"]
    x = np.pad(wave.astype(np.float64), n_fft // 2, mode="reflect")
    n = 1 + len(wave) // hop
    frames = np.stack([x[t * hop : t * hop + n_fft] for t in range(n)])
    power = np.abs(np.fft.rfft(frames * _hann(n_fft), n_fft)) ** 2
    mel = power @ _slaney_mel(sr, n_fft, cfg["mel_bins"], cfg["fmin"], cfg["fmax"])
    return 10.0 * np.log10(np.maximum(mel, 1e-10))


def _htk_mel(n_mels=64, n_bins=257, sr=16000, lo=125.0, hi=7500.0):
    """VGGish's spectrogram_to_mel_matrix: [n_bins, n_mels], DC row zeroed."""

    def mel(f):
        return 1127.0 * np.log1p(np.asarray(f, dtype=np.float64) / 700.0)

    bins = mel(np.linspace(0.0, sr / 2, n_bins))
    edges = np.linspace(mel(lo), mel(hi), n_mels + 2)
    w = np.empty((n_bins, n_mels))
    for i in range(n_mels):
        lower = (bins - edges[i]) / (edges[i + 1] - edges[i])
        upper = (edges[i + 2] - bins) / (edges[i + 2] - edges[i + 1])
        w[:, i] = np.maximum(0.0, np.minimum(lower, upper))
    w[0, :] = 0.0
    return w


def _vggish_logmel_np(wave, num_frames):
    frames = np.stack([wave[t * 160 : t * 160 + 400] for t in range(num_frames)])
    mag = np.abs(np.fft.rfft(frames.astype(np.float64) * _hann(400), 512))
    return np.log(mag @ _htk_mel() + 0.01)


# float32 matmul-DFT against the float64 FFT, in dB / log units.
LOGMEL_ATOL = 2e-3


@pytest.mark.parametrize("sr", [8000, 16000, 32000, 48000])
@pytest.mark.parametrize("case", ["masked", "short"])
def test_pann_logmel_matches_numpy(sr, case):
    import jax.numpy as jnp

    cfg = fe.PANN_CONFIGS[sr]
    n_fft, hop = cfg["window_size"], cfg["hop_size"]
    rng = np.random.default_rng(sr)
    if case == "masked":
        lengths = [sr, sr + 7 * hop + 3]  # 1 s and a bit more: two frame counts
    else:
        lengths = [n_fft // 2 + 5 * hop + 1]  # a few frames only
    waves = [(0.1 * rng.standard_normal(n)).astype(np.float32) for n in lengths]
    n_valid = [fe.pann_num_frames(n, hop) for n in lengths]
    num_frames = max(n_valid) + 2  # rows past every file's count must be 0
    length = (num_frames - 1) * hop + n_fft
    batch = np.zeros((len(waves), length), np.float32)
    for i, w in enumerate(waves):
        padded = fe.reflect_pad_host(w, n_fft)
        batch[i, : padded.size] = padded
    got = np.asarray(
        fe.pann_logmel_batch(
            jnp.asarray(batch), sr, num_frames, jnp.asarray(n_valid, jnp.int32)
        )
    )
    assert got.shape == (len(waves), num_frames, cfg["mel_bins"])
    for i, w in enumerate(waves):
        np.testing.assert_allclose(got[i, : n_valid[i]], _pann_logmel_np(w, sr), atol=LOGMEL_ATOL)
        assert np.all(got[i, n_valid[i] :] == 0.0)


@pytest.mark.parametrize("num_frames", [96, 296, 480])
def test_vggish_logmel_matches_numpy(num_frames):
    import jax.numpy as jnp

    rng = np.random.default_rng(num_frames)
    wave = (0.1 * rng.standard_normal(400 + (num_frames - 1) * 160)).astype(np.float32)
    expected = _vggish_logmel_np(wave, num_frames)
    for impl in ("xla", "auto"):  # host-facing chunk-sum and the pipeline's single matmul
        got = np.asarray(fe.vggish_logmel_batch(jnp.asarray(wave)[None], num_frames, impl=impl)[0])
        np.testing.assert_allclose(got, expected, atol=LOGMEL_ATOL)


# ---------------------------------------------------------------------------
# CLAP Swin block reference
# ---------------------------------------------------------------------------


def _layer_norm_np(x, p, eps=1e-5):
    mean = x.mean(-1, keepdims=True)
    var = x.var(-1, keepdims=True)
    return (x - mean) / np.sqrt(var + eps) * p["gamma"] + p["beta"]


def _swin_block_np(p, x, res, heads, shift, ws=clap.WINDOW_SIZE):
    """Swin-Transformer block as published (Liu et al. 2021), float64."""
    p = _to_np(p)
    b, l, c = x.shape
    hd = c // heads
    n = ws * ws
    h = _layer_norm_np(x, p["norm1"]).reshape(b, res, res, c)
    if shift:
        h = np.roll(h, (-shift, -shift), axis=(1, 2))
    # Window labels for the shift mask: the rolled image splits into 3x3
    # regions; tokens attend only within their region.
    region = np.zeros((res, res), np.int64)
    if shift:
        cuts = (slice(0, -ws), slice(-ws, -shift), slice(-shift, None))
        k = 0
        for hs in cuts:
            for wsl in cuts:
                region[hs, wsl] = k
                k += 1
    # Relative position index of token pairs inside a window.
    coords = np.array([(i, j) for i in range(ws) for j in range(ws)])
    rel = coords[:, None, :] - coords[None, :, :] + (ws - 1)
    rel_idx = rel[..., 0] * (2 * ws - 1) + rel[..., 1]
    bias = p["rel_bias"][rel_idx].transpose(2, 0, 1)  # [heads, n, n]
    out = np.empty_like(h)
    for bi in range(b):
        for wi in range(res // ws):
            for wj in range(res // ws):
                sl = (bi, slice(wi * ws, (wi + 1) * ws), slice(wj * ws, (wj + 1) * ws))
                t = h[sl].reshape(n, c)
                qkv = t @ p["qkv"]["w"] + p["qkv"]["b"]
                q, k_, v = (qkv[:, i * c : (i + 1) * c].reshape(n, heads, hd).transpose(1, 0, 2)
                            for i in range(3))
                logits = (q * hd ** -0.5) @ k_.transpose(0, 2, 1) + bias
                lab = region[sl[1], sl[2]].reshape(n)
                logits = logits + np.where(lab[:, None] != lab[None, :], -100.0, 0.0)
                a = np.exp(logits - logits.max(-1, keepdims=True))
                a /= a.sum(-1, keepdims=True)
                o = (a @ v).transpose(1, 0, 2).reshape(n, c)
                out[sl] = (o @ p["proj"]["w"] + p["proj"]["b"]).reshape(ws, ws, c)
    if shift:
        out = np.roll(out, (shift, shift), axis=(1, 2))
    x = x + out.reshape(b, l, c)
    m = _layer_norm_np(x, p["norm2"]) @ p["mlp"]["fc1"]["w"] + p["mlp"]["fc1"]["b"]
    m = 0.5 * m * (1.0 + erf(m / np.sqrt(2.0)))
    return x + m @ p["mlp"]["fc2"]["w"] + p["mlp"]["fc2"]["b"]


def _to_np(tree):
    if isinstance(tree, dict):
        return {k: _to_np(v) for k, v in tree.items()}
    return np.asarray(tree, np.float64)


def _block_params(rng, c, heads, ws=clap.WINDOW_SIZE):
    """Random block params at weight scales that keep every term visible
    (bias and shift mask included) in the output."""

    def normal(*shape, std):
        return (std * rng.standard_normal(shape)).astype(np.float32)

    return {
        "norm1": {"gamma": 1 + normal(c, std=0.1), "beta": normal(c, std=0.1)},
        "qkv": {"w": normal(c, 3 * c, std=c ** -0.5), "b": normal(3 * c, std=0.1)},
        "rel_bias": normal((2 * ws - 1) ** 2, heads, std=1.0),
        "proj": {"w": normal(c, c, std=c ** -0.5), "b": normal(c, std=0.1)},
        "norm2": {"gamma": 1 + normal(c, std=0.1), "beta": normal(c, std=0.1)},
        "mlp": {
            "fc1": {"w": normal(c, 4 * c, std=c ** -0.5), "b": normal(4 * c, std=0.1)},
            "fc2": {"w": normal(4 * c, c, std=(4 * c) ** -0.5), "b": normal(c, std=0.1)},
        },
    }


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
@pytest.mark.parametrize("shifted", [False, True])
def test_swin_block_matches_numpy(stage, shifted):
    import jax
    import jax.numpy as jnp

    res, heads, c = clap._STAGE_RES[stage], clap.NUM_HEADS[stage], clap._STAGE_DIMS[stage]
    shift = clap.WINDOW_SIZE // 2 if shifted else 0
    rng = np.random.default_rng(10 * stage + shifted)
    p = _block_params(rng, c, heads)
    x = rng.standard_normal((1, res * res, c)).astype(np.float32)
    got = np.asarray(
        jax.jit(clap._swin_block, static_argnums=(2, 3, 4))(
            jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x), res, heads, shift
        )
    )
    expected = _swin_block_np(p, x.astype(np.float64), res, heads, shift)
    np.testing.assert_allclose(got, expected, rtol=1e-4, atol=1e-4)
