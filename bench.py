"""Per-family step benchmarks on the GPU.

Driver mode (no args): prints ONE JSON line — the flagship VGGish fused
embed+stats step throughput (audio-min/s per device) plus a "families" field
with every variant's step throughput, and the device it ran on.

Extended modes (logged to stderr):
  python bench.py --families   # per-variant jitted-step throughput
                               # (all seven: vggish, pann-8k/16k/32k, clap,
                               #  encodec-24k/48k)
  python bench.py --e2e        # warm end-to-end score() throughput per family

The step benches time the fused embed+stats device program of
score(device_stats=True) — frontend -> model -> masked streaming (N, Σx,
Σxxᵀ) accumulator — at the shipped batch (config.DEFAULT_FILE_BATCH). Each
timed window ends in block_until_ready. A failure exits non-zero; there is
no partial record.
"""

from __future__ import annotations

import json
import sys
import time

sys.path.insert(0, ".")

CLIP_SECONDS = 10.0
PATCH_SECONDS = 0.96


def _time_stats_step(step_fn, acc, args, n_iters=24):
    """Seconds per fused embed+stats step. The accumulator is carried on
    device (each step consumes the previous step's state, so the device
    executes them back to back); the window ends when the last state is
    ready."""
    import jax

    jax.block_until_ready(step_fn(acc, *args))  # compile + warmup
    t0 = time.perf_counter()
    for _ in range(n_iters):
        acc = step_fn(acc, *args)
    jax.block_until_ready(acc)
    return (time.perf_counter() - t0) / n_iters


def _shipped_batch(family):
    from frechet_audio_distance_exported_tpu.config import DEFAULT_FILE_BATCH

    return DEFAULT_FILE_BATCH[family]


def _shipped_dtype(family, params):
    """Apply the production model-compute dtype (config.model_dtype) so the
    step benches measure the shipped configuration. Returns (dtype, cast
    params)."""
    import jax.numpy as jnp

    from frechet_audio_distance_exported_tpu.config import model_dtype
    from frechet_audio_distance_exported_tpu.pipeline import cast_model_params

    dt = model_dtype()
    if dt != jnp.float32:
        params = cast_model_params(family, params, dt)
    return dt, params


def _accumulate(acc, emb):
    """Fold a [..., d] embedding chunk into the streaming accumulator (the
    device_stats scoring path; all rows valid in the benches)."""
    import jax.numpy as jnp

    from frechet_audio_distance_exported_tpu.ops import stats

    return stats.update_stats(acc, emb, jnp.ones(emb.shape[:-1], jnp.float32))


def bench_vggish(files_per_step=None):
    import jax
    import jax.numpy as jnp

    from frechet_audio_distance_exported_tpu.models.vggish import (
        init_vggish_params,
        vggish_forward,
    )
    from frechet_audio_distance_exported_tpu.ops import frontends as fe
    from frechet_audio_distance_exported_tpu.ops import stats

    files_per_step = files_per_step or _shipped_batch("vggish")
    params = init_vggish_params(jax.random.PRNGKey(0))
    cdt, params = _shipped_dtype("vggish", params)
    s = int(CLIP_SECONDS * fe.VGGISH_SAMPLE_RATE)
    num_patches = fe.vggish_num_patches(s)

    @jax.jit
    def step(acc, params, wave):
        patches = fe.vggish_patches_batch(wave, num_patches, impl="auto")
        emb = vggish_forward(params, patches.reshape(-1, 96, 64).astype(cdt))
        return _accumulate(acc, emb.astype(jnp.float32))

    wave = jax.random.normal(jax.random.PRNGKey(1), (files_per_step, s), jnp.float32) * 0.1
    dt = _time_stats_step(step, stats.init_stats(128), (params, wave))
    patches_per_sec = files_per_step * num_patches / dt
    return patches_per_sec * PATCH_SECONDS / 60.0


def _bench_pann(sr, files_per_step=None):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from frechet_audio_distance_exported_tpu.models.pann import init_pann_params, pann_forward
    from frechet_audio_distance_exported_tpu.ops import frontends as fe
    from frechet_audio_distance_exported_tpu.ops import stats

    files_per_step = files_per_step or _shipped_batch("pann")
    params = init_pann_params(jax.random.PRNGKey(0))
    cdt, params = _shipped_dtype("pann", params)
    cfg = fe.PANN_CONFIGS[sr]
    n_fft, hop = cfg["window_size"], cfg["hop_size"]
    t_i = fe.pann_num_frames(int(CLIP_SECONDS * sr), hop)
    grid = fe.pann_valid_time(t_i)
    length = grid * hop + n_fft

    @jax.jit
    def step(acc, params, wave, n_valid):
        mel = fe.pann_logmel_batch(wave, sr, grid, n_valid)
        emb = pann_forward(params, mel.astype(cdt))
        return _accumulate(acc, emb.astype(jnp.float32))

    wave = jax.random.normal(jax.random.PRNGKey(1), (files_per_step, length), jnp.float32) * 0.1
    n_valid = jnp.full((files_per_step,), t_i, jnp.int32)
    dt = _time_stats_step(step, stats.init_stats(2048), (params, wave, n_valid))
    return files_per_step * CLIP_SECONDS / 60.0 / dt


def bench_pann8k(files_per_step=None):
    return _bench_pann(8000, files_per_step)


def bench_pann16k(files_per_step=None):
    return _bench_pann(16000, files_per_step)


def bench_pann32k(files_per_step=None):
    return _bench_pann(32000, files_per_step)


def bench_clap(files_per_step=None):
    import jax
    import jax.numpy as jnp

    from frechet_audio_distance_exported_tpu.models.clap import clap_forward, init_clap_params
    from frechet_audio_distance_exported_tpu.ops import frontends as fe
    from frechet_audio_distance_exported_tpu.ops import stats

    files_per_step = files_per_step or _shipped_batch("clap")
    params = init_clap_params(jax.random.PRNGKey(0))
    cdt, params = _shipped_dtype("clap", params)
    n_fft = fe.PANN_CONFIGS[fe.CLAP_SAMPLE_RATE]["window_size"]
    length = fe.CLAP_MAX_SAMPLES + n_fft  # reflect-padded 10 s @ 48 kHz

    @jax.jit
    def step(acc, params, wave, n_valid):
        mel = fe.pann_logmel_batch(wave, fe.CLAP_SAMPLE_RATE, fe.CLAP_TIME_FRAMES, n_valid)
        emb = clap_forward(params, mel.astype(cdt))
        return _accumulate(acc, emb.astype(jnp.float32))

    wave = jax.random.normal(jax.random.PRNGKey(1), (files_per_step, length), jnp.float32) * 0.1
    n_valid = jnp.full((files_per_step,), fe.CLAP_TIME_FRAMES, jnp.int32)
    dt = _time_stats_step(step, stats.init_stats(512), (params, wave, n_valid))
    return files_per_step * CLIP_SECONDS / 60.0 / dt


def _bench_encodec(sample_rate, causal, channels, files_per_step):
    import jax
    import jax.numpy as jnp

    from frechet_audio_distance_exported_tpu.models.encodec import (
        encodec_forward,
        init_encodec_params,
    )

    files_per_step = files_per_step or _shipped_batch("encodec")
    params = init_encodec_params(jax.random.PRNGKey(0), causal=causal, channels=channels)
    _, params = _shipped_dtype("encodec", params)
    s = int(CLIP_SECONDS * sample_rate)

    from frechet_audio_distance_exported_tpu.ops import stats

    @jax.jit
    def step(acc, params, wave):
        return _accumulate(acc, encodec_forward(params, wave, causal=causal))

    wave = jax.random.normal(
        jax.random.PRNGKey(1), (files_per_step, channels, s), jnp.float32
    ) * 0.1
    dt = _time_stats_step(step, stats.init_stats(128), (params, wave))
    return files_per_step * CLIP_SECONDS / 60.0 / dt


def bench_encodec24k(files_per_step=None):
    return _bench_encodec(24000, causal=True, channels=1, files_per_step=files_per_step)


def bench_encodec48k(files_per_step=None):
    return _bench_encodec(48000, causal=False, channels=2, files_per_step=files_per_step)


FAMILY_BENCHES = {
    "vggish": bench_vggish,
    "pann-8k": bench_pann8k,
    "pann-16k": bench_pann16k,
    "pann-32k": bench_pann32k,
    "clap": bench_clap,
    "encodec-24k": bench_encodec24k,
    "encodec-48k": bench_encodec48k,
}


def bench_e2e(model_name: str, num_files: int = 64) -> float:
    """Warm end-to-end score() throughput (audio-min/sec) on temp WAV dirs."""
    import os
    import tempfile

    import numpy as np

    from frechet_audio_distance_exported_tpu import FrechetAudioDistance
    from frechet_audio_distance_exported_tpu.utils.audio_io import write_wav

    fad = FrechetAudioDistance(model_name=model_name, weights="random")
    sr = fad.sample_rate
    rng = np.random.default_rng(0)
    bg, ev = tempfile.mkdtemp(), tempfile.mkdtemp()
    for i in range(num_files):
        clip = (rng.standard_normal(int(sr * CLIP_SECONDS)) * 0.1).astype(np.float32)
        write_wav(os.path.join(bg, f"{i}.wav"), clip, sr)
        write_wav(os.path.join(ev, f"{i}.wav"), clip * 0.9, sr)
    fad.score(bg, ev)  # warm: compile all buckets
    t0 = time.perf_counter()
    score = fad.score(bg, ev)
    dt = time.perf_counter() - t0
    if score == -1:
        raise RuntimeError(f"{model_name}: score() returned the -1 error sentinel")
    return 2 * num_files * CLIP_SECONDS / 60.0 / dt


def _device():
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind, "count": len(jax.devices())}


def main():
    import jax

    if jax.default_backend() != "gpu":
        sys.exit(f"bench.py measures the GPU; JAX found {jax.default_backend()!r}")
    args = set(sys.argv[1:])
    if "--families" in args:
        for name, fn in FAMILY_BENCHES.items():
            v = fn()
            print(f"[bench] {name} step: {v:.1f} audio-min/s/device", file=sys.stderr, flush=True)
        return
    if "--e2e" in args:
        for name in ("vggish", "pann-16k", "clap", "encodec-24k"):
            v = bench_e2e(name)
            print(f"[bench] {name} e2e score(): {v:.1f} audio-min/s", file=sys.stderr, flush=True)
        return

    families = {name: fn() for name, fn in FAMILY_BENCHES.items()}
    print(json.dumps({
        "metric": "vggish_embedding_throughput",
        "value": families["vggish"],
        "unit": "audio_min/sec/device",
        "families": families,
        "device": _device(),
    }), flush=True)


if __name__ == "__main__":
    main()
