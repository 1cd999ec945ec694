"""Run the FAD scoring path on the GPU once and check what comes out.

    python chip_smoke.py              # one GPU: device, main path, families, precision
    python chip_smoke.py --four-gpu   # only the data mesh over 4 GPUs vs one GPU

Every phase prints its own lines and raises on a failed check, so any
failure exits non-zero. The last line of standard output is one JSON object,
{"ok": true, "device": {...}}, printed only when every phase passed. Weights
are random and seeded (see HE_GAIN), and the audio is seeded noise and tones
written as PCM16 WAV files to temporary directories.

Phases:
  device     JAX's default backend must be the GPU. Prints the card's name and
             power limit (nvidia-smi), its device kind and the compile cache.
  main       VGGish score() on 64 + 64 ten-second clips along both statistics
             paths: host float64 (device_stats=False, the default) and
             streamed on the device (device_stats=True).
  families   all seven families through score() on 8 + 8 clips each (EnCodec
             clips are 5 s: clips over 10 s raise there).
  precision  which float32 product each FAD_TPU_PRECISION setting runs; per
             family, on the same clips: the shipped embeddings against
             FAD_TPU_PRECISION=highest on the card, and the card at highest
             against the CPU backend at highest (the plain reference).
  four-gpu   (--four-gpu only) vggish, pann-16k and clap scored with
             device_stats=True under data_mesh(jax.devices()[:4]) against one
             GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 0
MAIN_CLIPS = 64
FAMILY_CLIPS = 8
CLIP_SECONDS = 10.0
ENCODEC_CLIP_SECONDS = 5.0
FAMILIES = (
    "vggish", "pann-8k", "pann-16k", "pann-32k", "clap", "encodec-24k", "encodec-48k",
)
MESH_FAMILIES = ("vggish", "pann-16k", "clap")
MESH_DEVICES = 4

# Random weights, seeded, saved as .npz weight bundles and loaded through the
# weights="auto" path like real ones. Under the torch-default init
# (uniform +-1/sqrt(fan_in)) every conv+ReLU shrinks the activation variance
# ~6x, so after the VGGish and CNN14 stacks the embeddings are bias constants
# that barely move with the input (PANN: the input-dependent part is ~3e-5 of
# the embedding) and no precision comparison could see the network. Their
# weight tensors are scaled by sqrt(6), i.e. variance 2/fan_in (He's rule).
HE_GAIN = {"vggish": 6 ** 0.5, "pann": 6 ** 0.5}

# Tolerances, all relative to the score being compared against.
SAME_DIR_RTOL = 1e-4  # score(bg, bg) against score(bg, ev): about 0
# Host float64 statistics against float32 sums streamed on the device; the
# sums of rank-deficient covariances (8 rows, d up to 2048) carry float32
# rounding into every eigenvalue the epilogue takes a square root of.
PATH_RTOL = 1e-3
# The repo's parity bar: the FAD of two embedding sets moves by at most this.
FAD_RTOL = 1e-3
# Mesh against one GPU: the same programs on a quarter of the batch each.
MESH_RTOL = 1e-3


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def check_devices(devices, need: int) -> None:
    """Exit non-zero unless the first ``need`` devices are GPUs."""
    if not devices or devices[0].platform != "gpu":
        platform = devices[0].platform if devices else None
        raise SystemExit(f"chip_smoke: JAX found no GPU (default platform {platform!r})")
    gpus = [d for d in devices if d.platform == "gpu"]
    if len(gpus) < need:
        raise SystemExit(f"chip_smoke: this phase needs {need} GPUs, JAX found {len(gpus)}")


def rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def score_ok(name: str, value: float) -> None:
    check(value != -1, f"{name}: score() returned the -1 error sentinel")
    check(bool(np.isfinite(value)), f"{name}: score {value} is not finite")
    check(value > 0, f"{name}: score {value} is not above 0")


def peak_bytes() -> int:
    import jax

    return int(jax.devices()[0].memory_stats()["peak_bytes_in_use"])


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


# ---------------------------------------------------------------------------
# Corpora
# ---------------------------------------------------------------------------


def write_corpus(root: str, sample_rate: int, n: int, seconds: float, seed: int):
    """Seeded background/eval dirs of n PCM16 WAV clips each: the background
    is noise, the eval set noise plus a tone, so their FAD is well above 0."""
    from frechet_audio_distance_exported_tpu.utils.audio_io import write_wav

    rng = np.random.default_rng(seed)
    t = np.arange(int(sample_rate * seconds), dtype=np.float64) / sample_rate
    bg, ev = os.path.join(root, "bg"), os.path.join(root, "ev")
    os.makedirs(bg)
    os.makedirs(ev)
    for i in range(n):
        noise = 0.1 * rng.standard_normal(t.size)
        write_wav(os.path.join(bg, f"{i:03d}.wav"), noise.astype(np.float32), sample_rate)
        freq = rng.uniform(200.0, 0.2 * sample_rate)
        tone = 0.1 * rng.standard_normal(t.size) + 0.3 * np.sin(2 * np.pi * freq * t)
        write_wav(os.path.join(ev, f"{i:03d}.wav"), tone.astype(np.float32), sample_rate)
    return bg, ev


def _scale_weights(tree, gain: float):
    if isinstance(tree, dict):
        return {k: (v * gain if k == "w" and getattr(v, "ndim", 0) >= 2
                    else _scale_weights(v, gain)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_scale_weights(v, gain) for v in tree]
    return tree


def write_bundle(model: str, ckpt_dir: str) -> None:
    """Seeded random weights for ``model`` as a bundle in ``ckpt_dir``."""
    from frechet_audio_distance_exported_tpu import registry
    from frechet_audio_distance_exported_tpu.utils import weights

    cfg = registry.get_model_config(model)
    params = weights.init_random_params(model, SEED)
    if cfg.family in HE_GAIN:
        params = _scale_weights(params, HE_GAIN[cfg.family])
    weights.save_weights(os.path.join(ckpt_dir, cfg.weight_filename), params)


def make_fad(model: str, tmp: str, **kw):
    """FrechetAudioDistance over the seeded bundle (written on first use)."""
    from frechet_audio_distance_exported_tpu import FrechetAudioDistance, registry

    ckpt = os.path.join(tmp, "ckpt")
    os.makedirs(ckpt, exist_ok=True)
    if not os.path.exists(os.path.join(ckpt, registry.get_model_config(model).weight_filename)):
        write_bundle(model, ckpt)
    return FrechetAudioDistance(model_name=model, ckpt_dir=ckpt, **kw)


def clip_seconds(model: str) -> float:
    return ENCODEC_CLIP_SECONDS if model.startswith("encodec") else CLIP_SECONDS


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_device() -> None:
    import jax

    from frechet_audio_distance_exported_tpu.config import enable_compilation_cache

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    for line in smi.stdout.strip().splitlines():
        print(f"[device] nvidia-smi: {line.strip()}")
    d = jax.devices()[0]
    print(f"[device] jax: platform={d.platform} kind={d.device_kind} count={len(jax.devices())}")
    enable_compilation_cache()
    print(f"[device] compile cache: {jax.config.jax_compilation_cache_dir}")
    print(f"[device] bytes_limit: {(d.memory_stats() or {}).get('bytes_limit')}")


def phase_precision_probe() -> None:
    import jax

    # Which float32 product the card ran at each FAD_TPU_PRECISION setting:
    # TF32 rounds operands to a 10-bit mantissa (~1e-3 relative error on a
    # 1024-deep product), full float32 stays near 1e-6.
    rng = np.random.default_rng(SEED)
    a = rng.standard_normal((1024, 1024)).astype(np.float32)
    b = rng.standard_normal((1024, 1024)).astype(np.float32)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    for name, prec in (("high", jax.lax.Precision.HIGH), ("highest", jax.lax.Precision.HIGHEST)):
        out = np.asarray(jax.jit(lambda x, y, p=prec: jax.numpy.matmul(x, y, precision=p))(a, b))
        err = float(np.max(np.abs(out - exact)) / np.max(np.abs(exact)))
        kind = "TF32" if err > 1e-4 else "float32"
        print(f"[device] FAD_TPU_PRECISION={name}: 1024-deep f32 product max rel err {err:.3e} -> {kind}")


def _score_both_paths(fad, bg: str, ev: str, tag: str) -> dict:
    """score() along both statistics paths, first (compiling) and warm."""
    out = {}
    for path, dev in (("host", False), ("device", True)):
        first, t_first = timed(lambda: fad.score(bg, ev, device_stats=dev))
        warm, t_warm = timed(lambda: fad.score(bg, ev, device_stats=dev))
        score_ok(f"{tag} {path}", first)
        score_ok(f"{tag} {path} warm", warm)
        again = rel(warm, first)
        check(again <= FAD_RTOL, f"{tag} {path}: warm score off the first by {again:.3e}")
        out[path] = first
        print(
            f"[{tag}] {path:6s} score={first:.9e} first_s={t_first:.3f} "
            f"warm_s={t_warm:.3f} warm_vs_first_rel={again:.1e} "
            f"peak_bytes_in_use={peak_bytes()}"
        )
    same = fad.score(bg, bg)
    check(same != -1, f"{tag}: score(bg, bg) returned -1")
    check(abs(same) <= SAME_DIR_RTOL * out["host"],
          f"{tag}: score(bg, bg) = {same} not about 0 (rtol {SAME_DIR_RTOL})")
    d = rel(out["device"], out["host"])
    check(d <= PATH_RTOL, f"{tag}: device-stats score off the host score by {d:.3e} > {PATH_RTOL}")
    print(f"[{tag}] score(bg,bg)={same:.3e}; device vs host rel {d:.3e} (tol {PATH_RTOL})")
    return out


def phase_main(tmp: str) -> None:
    bg, ev = write_corpus(os.path.join(tmp, "main"), 16000, MAIN_CLIPS, CLIP_SECONDS, SEED)
    fad = make_fad("vggish", tmp)
    print(f"[main] vggish {MAIN_CLIPS}+{MAIN_CLIPS} clips of {CLIP_SECONDS} s, "
          f"file_batch={fad.pipeline.file_batch}")
    _score_both_paths(fad, bg, ev, "main")


def _full_batch_step(fad, model: str) -> None:
    """One device-statistics chunk at the shipped batch (file_batch clips,
    in memory), so peak_bytes_in_use covers the default batch and not only
    the 8-clip corpus."""
    import jax

    rng = np.random.default_rng(SEED + 3)
    n = fad.pipeline.file_batch
    size = int(fad.sample_rate * clip_seconds(model))
    clips = [(0.1 * rng.standard_normal(size)).astype(np.float32) for _ in range(n)]
    state, secs = timed(
        lambda: jax.block_until_ready(fad.pipeline.accumulate_stats(clips, fad.sample_rate))
    )
    check(state is not None and float(state.n) > 0, f"{model}: full-batch chunk folded no rows")
    check(bool(np.isfinite(np.asarray(state.ss)).all()), f"{model}: full-batch stats not finite")
    print(f"[{model}] full batch B={n}: one device-stats chunk first_s={secs:.3f} "
          f"peak_bytes_in_use={peak_bytes()}")


def _row_rel_err(a: np.ndarray, b: np.ndarray) -> float:
    """Max over rows of ||a_i - b_i|| / ||b_i||."""
    num = np.linalg.norm(a.astype(np.float64) - b, axis=1)
    return float(np.max(num / np.maximum(np.linalg.norm(b.astype(np.float64), axis=1), 1e-30)))


def _embed_pair(fad, bg: str, ev: str):
    e_bg = fad.get_embeddings(fad._load_audio_files(bg), fad.sample_rate)
    e_ev = fad.get_embeddings(fad._load_audio_files(ev), fad.sample_rate)
    return e_bg, e_ev, fad._frechet_from_embeddings(e_bg, e_ev)


def phase_family(model: str, tmp: str) -> None:
    import jax

    fad = make_fad(model, tmp)
    bg, ev = write_corpus(
        os.path.join(tmp, model), fad.sample_rate, FAMILY_CLIPS, clip_seconds(model), SEED + 1
    )
    print(f"[{model}] {FAMILY_CLIPS}+{FAMILY_CLIPS} clips of {clip_seconds(model)} s, "
          f"file_batch={fad.pipeline.file_batch}")
    _score_both_paths(fad, bg, ev, model)
    _full_batch_step(fad, model)

    # Precision: shipped vs highest on the card, then the card vs the CPU.
    ship_bg, ship_ev, ship_fad = _embed_pair(fad, bg, ev)
    os.environ["FAD_TPU_PRECISION"] = "highest"
    try:
        hi_bg, hi_ev, hi_fad = _embed_pair(fad, bg, ev)
        with jax.default_device(jax.devices("cpu")[0]):
            cpu = make_fad(model, tmp)
            cpu_bg, cpu_ev, cpu_fad = _embed_pair(cpu, bg, ev)
    finally:
        del os.environ["FAD_TPU_PRECISION"]
    for e in (ship_bg, ship_ev, hi_bg, hi_ev, cpu_bg, cpu_ev):
        check(bool(np.isfinite(e).all()), f"{model}: non-finite embeddings")
    ship_err = max(_row_rel_err(ship_bg, hi_bg), _row_rel_err(ship_ev, hi_ev))
    cpu_err = max(_row_rel_err(hi_bg, cpu_bg), _row_rel_err(hi_ev, cpu_ev))
    ship_d, cpu_d = rel(ship_fad, hi_fad), rel(hi_fad, cpu_fad)
    print(f"[{model}] precision shipped(high) vs card highest: embedding max row rel err "
          f"{ship_err:.3e}; FAD {ship_fad:.9e} vs {hi_fad:.9e}, rel delta {ship_d:.3e} (tol {FAD_RTOL})")
    print(f"[{model}] precision card highest vs cpu highest: embedding max row rel err "
          f"{cpu_err:.3e}; FAD {hi_fad:.9e} vs {cpu_fad:.9e}, rel delta {cpu_d:.3e} (tol {FAD_RTOL})")
    check(ship_d <= FAD_RTOL, f"{model}: shipped vs highest FAD delta {ship_d:.3e} > {FAD_RTOL}")
    check(cpu_d <= FAD_RTOL, f"{model}: card vs cpu FAD delta {cpu_d:.3e} > {FAD_RTOL}")


def phase_four_gpu(tmp: str, devices) -> None:
    from frechet_audio_distance_exported_tpu.parallel.mesh import data_mesh

    mesh = data_mesh(devices)
    for model in MESH_FAMILIES:
        one = make_fad(model, tmp)
        n = 2 * one.pipeline.file_batch
        bg, ev = write_corpus(os.path.join(tmp, "mesh-" + model), one.sample_rate, n,
                              CLIP_SECONDS, SEED + 2)
        s_one, t_one = timed(lambda: one.score(bg, ev, device_stats=True))
        meshed = make_fad(model, tmp, mesh=mesh)
        s_mesh, t_mesh = timed(lambda: meshed.score(bg, ev, device_stats=True))
        _, w_one = timed(lambda: one.score(bg, ev, device_stats=True))
        _, w_mesh = timed(lambda: meshed.score(bg, ev, device_stats=True))
        score_ok(f"{model} one-gpu", s_one)
        score_ok(f"{model} mesh", s_mesh)
        d = rel(s_mesh, s_one)
        print(f"[four-gpu] {model} {n}+{n} clips: mesh({len(devices)}) {s_mesh:.9e} "
              f"vs one {s_one:.9e}, rel {d:.3e} (tol {MESH_RTOL}); first_s mesh {t_mesh:.3f} "
              f"one {t_one:.3f}; warm_s mesh {w_mesh:.3f} one {w_one:.3f}")
        check(d <= MESH_RTOL, f"{model}: mesh vs one-GPU score rel {d:.3e} > {MESH_RTOL}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--four-gpu", action="store_true",
                        help="run only the data-mesh phase over 4 GPUs")
    args = parser.parse_args(argv)
    os.environ["FAD_TPU_OFFLINE"] = "1"  # random weights; never download

    import jax

    check_devices(jax.devices(), MESH_DEVICES if args.four_gpu else 1)
    if jax.default_backend() != "gpu":
        raise SystemExit(f"chip_smoke: default backend is {jax.default_backend()!r}, not gpu")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        phase_device()
        if args.four_gpu:
            phase_four_gpu(tmp, jax.devices()[:MESH_DEVICES])
        else:
            phase_precision_probe()
            phase_main(tmp)
            for model in FAMILIES:
                phase_family(model, tmp)
    d = jax.devices()[0]
    print(json.dumps({
        "ok": True,
        "device": {"platform": d.platform, "kind": d.device_kind, "count": len(jax.devices())},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
