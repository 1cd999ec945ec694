"""Device time of the PANN/CLAP log-mel frontends and the CLAP Swin stages
as XLA compiles them, read from one jax.profiler trace on the GPU.

    FAD_TPU_TRACE=chiprun_out/trace python scripts/profile_xla_split.py

Each piece runs as its own jitted program (so the trace names it by its XLA
module) at the shipped batch and full width on 10 s clips: the PANN-16k and
CLAP log-mel frontends, the four CLAP Swin stages on the patch-embedded
input, and the whole CLAP and PANN-16k forwards for scale. Prints device
milliseconds per call of each module, summed over its kernels, and the
card's name and power limit.
"""

from __future__ import annotations

import glob
import os
import subprocess
import sys
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from frechet_audio_distance_exported_tpu.config import DEFAULT_FILE_BATCH  # noqa: E402
from frechet_audio_distance_exported_tpu.models import clap, pann  # noqa: E402
from frechet_audio_distance_exported_tpu.ops import frontends as fe  # noqa: E402
from frechet_audio_distance_exported_tpu.utils import profiling  # noqa: E402

ITERS = 5


def programs():
    """name -> (jitted fn, args) for every piece the trace times."""
    b = DEFAULT_FILE_BATCH["clap"]
    key = iter(jax.random.split(jax.random.PRNGKey(0), 8))
    out = {}

    cfg = fe.PANN_CONFIGS[16000]
    t_i = fe.pann_num_frames(160000, cfg["hop_size"])
    grid = fe.pann_valid_time(t_i)
    pann_wave = 0.1 * jax.random.normal(next(key), (b, grid * cfg["hop_size"] + cfg["window_size"]))
    n_valid = jnp.full((b,), t_i, jnp.int32)

    def pann16k_frontend(w, n):
        return fe.pann_logmel_batch(w, 16000, grid, n)

    out["pann16k_frontend"] = (pann16k_frontend, (pann_wave, n_valid))
    pann_params = pann.init_pann_params(next(key))
    pann_mel = jax.jit(pann16k_frontend)(pann_wave, n_valid)

    def pann16k_forward(p, mel):
        return pann.pann_forward(p, mel)

    out["pann16k_forward"] = (pann16k_forward, (pann_params, pann_mel))

    clap_wave = 0.1 * jax.random.normal(next(key), (b, fe.CLAP_MAX_SAMPLES + 1024))
    clap_valid = jnp.full((b,), fe.CLAP_TIME_FRAMES, jnp.int32)

    def clap_frontend(w, n):
        return fe.pann_logmel_batch(w, fe.CLAP_SAMPLE_RATE, fe.CLAP_TIME_FRAMES, n)

    out["clap_frontend"] = (clap_frontend, (clap_wave, clap_valid))
    clap_params = clap.init_clap_params(next(key))
    clap_mel = jax.jit(clap_frontend)(clap_wave, clap_valid)

    def clap_forward(p, mel):
        return clap.clap_forward(p, mel)

    out["clap_forward"] = (clap_forward, (clap_params, clap_mel))

    def clap_swin_stages(p, x):
        for i, stage in enumerate(p["stages"]):
            res, heads = clap._STAGE_RES[i], clap.NUM_HEADS[i]
            for j, blk in enumerate(stage["blocks"]):
                shift = 0 if (j % 2 == 0 or res <= clap.WINDOW_SIZE) else clap.WINDOW_SIZE // 2
                x = clap._swin_block(blk, x, res, heads, shift)
            if "downsample" in stage:
                x = clap._patch_merging(stage["downsample"], x, res)
        return x

    tokens = jax.random.normal(next(key), (b, clap._STAGE_RES[0] ** 2, clap.EMBED_DIM))
    out["clap_swin_stages"] = (clap_swin_stages, (clap_params, tokens))
    return out


def device_ms_per_module(trace_dir: str):
    """{module: device ms summed over its kernels} from the newest trace."""
    paths = sorted(glob.glob(os.path.join(trace_dir, "plugins/profile/*/*.xplane.pb")))
    data = jax.profiler.ProfileData.from_file(paths[-1])
    totals = defaultdict(float)
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        print(f"trace plane {plane.name}: lines {[ln.name for ln in plane.lines]}",
              file=sys.stderr)
        for line in plane.lines:
            # Kernel events sit on the stream lines; the "XLA Modules" and
            # "XLA Ops" lines repeat the same time at coarser grain.
            if line.name.startswith("XLA"):
                continue
            for ev in line.events:
                stats = dict(ev.stats)
                module = str(stats.get("hlo_module", "?"))
                totals[module] += ev.duration_ns / 1e6
    return totals


def main() -> int:
    if jax.default_backend() != "gpu":
        sys.exit(f"profile_xla_split.py measures the GPU; JAX found {jax.default_backend()!r}")
    trace_dir = os.environ.get("FAD_TPU_TRACE")
    if not trace_dir:
        sys.exit("set FAD_TPU_TRACE to the trace directory")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    print(f"card: {smi.stdout.strip()}; device_kind {jax.devices()[0].device_kind}")
    progs = {name: (jax.jit(fn), args) for name, (fn, args) in programs().items()}
    for fn, args in progs.values():
        jax.block_until_ready(fn(*args))  # compile outside the trace
    with profiling.trace():
        for _ in range(ITERS):
            for fn, args in progs.values():
                jax.block_until_ready(fn(*args))
    totals = device_ms_per_module(trace_dir)
    for module, ms in sorted(totals.items(), key=lambda kv: -kv[1]):
        print(f"{module:40s} {ms / ITERS:10.3f} device ms/call (B={DEFAULT_FILE_BATCH['clap']})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
