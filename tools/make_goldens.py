#!/usr/bin/env python
"""Generate committed frontend golden arrays (tests/goldens/).

VGGish already has a golden captured from the reference's own NumPy frontend
(vggish_patches_sine440_3s.npy). This tool extends the set to the PANN/CLAP
librosa-style log-mel (all four sample-rate configs, reference:
models/pann.py:107-136) and the Encodec preprocessing incl. the Kaiser-sinc
resampler (reference: models/encodec.py:45-138), so that a regression in mel
or resampler numerics fails a committed-golden test rather than only the
independent in-repo reimplementation (tests/test_dsp.py).

Goldens are produced by the current implementation on CPU (deterministic) and
cross-checked against librosa/resampy by tests/test_goldens.py whenever those
packages are importable (they are not baked into this image).

Usage: python tools/make_goldens.py [--check]
  --check  verify the committed files match the current implementation
           instead of rewriting them (exit 1 on drift).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "tests", "goldens")


def _sine(duration: float, freq: float, sr: int) -> np.ndarray:
    """Same waveform formula as tests/conftest.py::generate_test_audio."""
    t = np.linspace(0, duration, int(sr * duration), dtype=np.float32)
    return (np.sin(2 * np.pi * freq * t) * 0.5).astype(np.float32)


def build_goldens() -> dict:
    from frechet_audio_distance_exported_tpu.ops import frontends as fe

    out = {}
    # PANN log-mel, all four SR configs (8k/16k/32k used by pann-*, 48k by CLAP).
    for sr in (8000, 16000, 32000, 48000):
        audio = _sine(2.0, 440.0, sr)
        mel = np.asarray(
            fe.waveform_to_logmel(audio, sr, target_sample_rate=sr, return_tensor=False)
        ).astype(np.float32)
        out[f"pann_logmel_sine440_2s_{sr}.npy"] = mel
    # CLAP: int16 quantization + pad-waveform-to-480000-BEFORE-mel rule
    # (reference: clap.py:70-72, fad.py:354-359) -> exactly 1001 frames.
    audio = _sine(2.0, 440.0, 48000)
    padded = np.pad(audio, (0, fe.CLAP_MAX_SAMPLES - len(audio)))
    out["clap_mel_sine440_2s_padded.npy"] = np.asarray(
        fe.preprocess_for_clap(padded, 48000, return_tensor=False)
    ).astype(np.float32)
    # Encodec preprocessing: exercises the Kaiser-sinc resampler (16k->24k
    # mono) and the mono->stereo duplicate + resample path (32k->48k).
    audio = _sine(1.0, 440.0, 16000)
    out["encodec_pre_sine440_1s_16k_to_24k.npy"] = np.asarray(
        fe.preprocess_for_encodec(audio, 16000, 24000, 1, return_tensor=False)
    ).astype(np.float32)
    audio = _sine(0.5, 440.0, 32000)
    out["encodec_pre_sine440_05s_32k_to_48k_stereo.npy"] = np.asarray(
        fe.preprocess_for_encodec(audio, 32000, 48000, 2, return_tensor=False)
    ).astype(np.float32)
    return out


def main():
    # Deterministic CPU numerics (goldens are CPU-defined like the tests
    # that read them).
    import jax

    try:
        jax.config.update("jax_platforms", "cpu")
    except Exception:
        pass

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--check", action="store_true")
    args = ap.parse_args()

    goldens = build_goldens()
    os.makedirs(GOLDEN_DIR, exist_ok=True)
    drift = False
    for name, arr in goldens.items():
        path = os.path.join(GOLDEN_DIR, name)
        if args.check:
            if not os.path.exists(path):
                print(f"MISSING {name}")
                drift = True
                continue
            ref = np.load(path)
            d = float(np.max(np.abs(arr - ref))) if arr.shape == ref.shape else float("inf")
            status = "OK" if d < 1e-5 else "DRIFT"
            drift |= status != "OK"
            print(f"{status:5} {name} (max diff {d:.2e})")
        else:
            np.save(path, arr)
            print(f"wrote {name} shape={arr.shape} ({arr.nbytes // 1024} KiB)")
    sys.exit(1 if drift else 0)


if __name__ == "__main__":
    main()
