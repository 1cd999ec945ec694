#!/usr/bin/env python
"""Stress dtype and precision settings across FAD score magnitudes.

This sweep runs the full shipped pipeline (at the current env settings)
against the forced exact path (FAD_TPU_PRECISION=highest + FAD_TPU_MODEL_DTYPE=float32 — XLA
chunk-sum frontends, f32 model, f32 LSTM operands) over pairs whose true
FAD spans several decades, and records the worst |delta| (abs and relative)
per family.

Pairs: eval audio interpolates between "same distribution as background"
(alpha=0) and "very different program" (alpha=1) — FAD grows ~alpha^2, so
the alpha grid spans ~4 decades of score.

encodec-48k additionally measures the full-mixed opt-in
(FAD_TPU_MODEL_DTYPE=bfloat16).

Usage: python scripts/exp_dtype_magnitude_sweep.py [--families vggish,...]
(run as the only process on the GPU.)
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FAMILIES = ["vggish", "pann-16k", "clap", "encodec-24k", "encodec-48k"]
ALPHAS = [0.03, 0.15, 0.5, 1.0]
N_CLIPS = 16
DUR = 2.0

EXACT_ENV = {"FAD_TPU_PRECISION": "highest", "FAD_TPU_MODEL_DTYPE": "float32"}
MODES = {
    "exact": EXACT_ENV,
    "shipped": {},  # platform defaults
}


def _bg_clip(i, sr, rng):
    t = np.arange(int(sr * DUR), dtype=np.float32) / sr
    x = 0.3 * np.sin(2 * np.pi * (400.0 + 3.0 * i) * t)
    x += 0.01 * rng.standard_normal(t.shape).astype(np.float32)
    return np.clip(x, -1, 1).astype(np.float32)


def _target_clip(i, sr, rng):
    t = np.arange(int(sr * DUR), dtype=np.float32) / sr
    # Different band, chirp + heavy noise: far from the background program.
    f0, f1 = 1200.0 + 17.0 * i, 2400.0 + 17.0 * i
    x = 0.5 * np.sin(2 * np.pi * (f0 * t + (f1 - f0) * t * t / (2 * DUR)))
    x += 0.15 * rng.standard_normal(t.shape).astype(np.float32)
    return np.clip(x, -1, 1).astype(np.float32)


def _dirs(sr):
    rng = np.random.default_rng(0)
    bg = [_bg_clip(i, sr, rng) for i in range(N_CLIPS)]
    evs = {}
    for a in ALPHAS:
        rng_e = np.random.default_rng(1)
        evs[a] = [
            np.clip(
                (1.0 - a) * _bg_clip(i + 50, sr, rng_e) + a * _target_clip(i, sr, rng_e),
                -1,
                1,
            ).astype(np.float32)
            for i in range(N_CLIPS)
        ]
    return bg, evs


def _set_env(env):
    for k in ("FAD_TPU_PRECISION", "FAD_TPU_MODEL_DTYPE", "FAD_TPU_LSTM_MATMUL"):
        os.environ.pop(k, None)
    os.environ.update(env)
    # The env-dependent branches (_resolve_frontend, matmul_precision,
    # single_matmul) resolve at TRACE time inside module-level jits, and a
    # later mode's calls with identical avals+statics would hit the stale
    # cached trace — 'shipped' would silently rerun the exact-mode kernels
    # (code-review r4 finding). Force retracing on every mode switch.
    import jax

    jax.clear_caches()


def _fads_for_mode(family, env, sr):
    from frechet_audio_distance_exported_tpu import FrechetAudioDistance
    from frechet_audio_distance_exported_tpu.ops import stats as stats_ops

    _set_env(env)
    fad = FrechetAudioDistance(model_name=family, weights="random", seed=7)
    bg, evs = _dirs(sr)
    emb_bg = np.asarray(fad.get_embeddings(bg, sr), np.float64)
    mu1, s1 = np.mean(emb_bg, 0), np.cov(emb_bg, rowvar=False)
    scores = {}
    for a, clips in evs.items():
        emb = np.asarray(fad.get_embeddings(clips, sr), np.float64)
        mu2, s2 = np.mean(emb, 0), np.cov(emb, rowvar=False)
        scores[a] = float(stats_ops.frechet_distance_eigh_np(mu1, s1, mu2, s2))
    del fad
    return scores


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--families", default=",".join(FAMILIES))
    ap.add_argument("--json", default="")
    args = ap.parse_args()

    signal.alarm(5400)
    import jax

    from frechet_audio_distance_exported_tpu import registry

    print(f"backend: {jax.default_backend()}", flush=True)
    results = {}
    for family in args.families.split(","):
        family = family.strip()
        sr = registry.get_model_config(family).sample_rate
        modes = dict(MODES)
        if family == "encodec-48k":
            modes["mixed_opt_in"] = {"FAD_TPU_MODEL_DTYPE": "bfloat16"}
        per_mode = {}
        for mode, env in modes.items():
            per_mode[mode] = _fads_for_mode(family, env, sr)
            print(f"{family:12s} {mode:12s} " + "  ".join(
                f"a={a}: {per_mode[mode][a]:.6g}" for a in ALPHAS), flush=True)
        fam = {"scores": per_mode, "worst": {}}
        for mode in per_mode:
            if mode == "exact":
                continue
            worst_abs = worst_rel = 0.0
            for a in ALPHAS:
                ref, v = per_mode["exact"][a], per_mode[mode][a]
                d = abs(v - ref)
                worst_abs = max(worst_abs, d)
                worst_rel = max(worst_rel, d / max(abs(ref), 1e-12))
            fam["worst"][mode] = {"abs": worst_abs, "rel": worst_rel}
            print(
                f"{family:12s} {mode} vs exact: worst |delta| {worst_abs:.3e} "
                f"(rel {worst_rel:.3e})",
                flush=True,
            )
        results[family] = fam
    _set_env({})

    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
        print(f"wrote {args.json}", flush=True)


if __name__ == "__main__":
    main()
