"""Batched embedding pipeline: the device-batched inversion of the
reference's per-file Python loop (reference: fad.py:302-408).

Design: the host only decodes/resamples (thread pool) and applies tiny
reflect pads; audio is then packed into a small set of static shape buckets
and pushed through ONE jitted batched function per (model, bucket) signature:

    waveform batch -> matmul-DFT frontend -> embedding network -> rows+masks

Static-shape planning rules (each is part of the reference numerics):
- VGGish: per-file patch count P_i = floor(frames_i / 96); patches beyond P_i
  are masked out (reference drops the tail, models/vggish.py:263-271).
- PANN: files are grouped by their minimal valid time grid T = 32k - 24;
  log-mel rows in [T_i, T) are zeroed exactly like the reference's zero pad
  (reference: fad.py:41-66). Files with different grids are never mixed —
  the grid length feeds global pooling and is observable in the embedding.
- CLAP: fixed [B, 1001, 64] (reference: fad.py:38, 354-362).
- Encodec: fixed 10 s waveforms; output trimmed to samples//320 frames
  (reference: fad.py:334-348).

Row ordering of the concatenated embedding matrix matches the reference
(files in input order; patches/frames in time order within a file).
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import registry
from .ops import frontends as fe
from .ops.resample import resample


def as_int16_exact(x: np.ndarray, full_scale: float = 32768.0) -> Optional[np.ndarray]:
    """int16 view of float audio that is exactly on the k/full_scale grid
    (i.e. decoded PCM16 that was never resampled/mixed), else None.

    Shipping int16 halves host->device transfer bytes; the jitted frontends
    dequantize on device losslessly (ops.frontends.dequant_i16).
    """
    q = np.round(x * full_scale)
    if q.size and -32768.0 <= q.min() and q.max() <= 32767.0 and np.array_equal(q / full_scale, x):
        return q.astype(np.int16)
    return None


def _pack_wave(rows, b: int, length: int, full_scale: float = 32768.0) -> np.ndarray:
    """Zero-padded batch buffer [b, *row_dims, length]; int16 iff every row
    is int16 (rows are zero-padded along their last axis; mixed chunks are
    dequantized on host into the float32 buffer)."""
    all_i16 = all(r.dtype == np.int16 for r in rows)
    wave = np.zeros(
        (b,) + rows[0].shape[:-1] + (length,), np.int16 if all_i16 else np.float32
    )
    for row, r in enumerate(rows):
        if r.dtype == np.int16 and not all_i16:
            r = r.astype(np.float32) / full_scale
        wave[row, ..., : r.shape[-1]] = r
    return wave


# Hard single-file cap for PANN: one file's [64ch, T, 64] block-1 activations
# must fit device memory alone (2^18 frames ~ 2.9 GB at float32 -> ~44 min @
# 16 kHz, ~2.3 h @ 32 kHz). The reference's export artifact capped T at 10016
# frames (~100 s); beyond our cap we fail loudly instead of OOMing the device.
# Scaled down by hbm_batch_scale() on devices with less memory (pann_frame_cap).
PANN_MAX_FRAMES = 1 << 18

# Device memory the default batches (config.DEFAULT_FILE_BATCH) need: the
# largest peak_bytes_in_use chip_smoke.py measured across the seven families
# at those batches with every program loaded from the compile cache
# (4,023,419,648 bytes, reached by encodec-48k at B=16 on an H100 80GB HBM3
# at a 700 W limit), rounded up. A cold compile peaks higher (8.4 GB) on
# autotuning scratch, which the autotuner fits to the free memory. Devices
# whose allocator limit is smaller divide the batches rather than OOM.
_KNEE_HBM_BYTES = 4 * 2**30


def _device_hbm_bytes():
    """Device 0's allocator bytes_limit, or None when the backend doesn't
    report one (the CPU backend)."""
    try:
        stats = jax.local_devices()[0].memory_stats() or {}
        return stats.get("bytes_limit")
    except Exception:
        return None


@functools.lru_cache(maxsize=1)
def hbm_batch_scale() -> int:
    """Power-of-two divisor for the default batches: 2x per halving of the
    device's memory limit below _KNEE_HBM_BYTES. Peak activation footprints
    scale linearly with batch, so halving batch per halved memory preserves
    the headroom proportions. No-op (1) when the limit is unknown or large
    enough. Cached: device memory cannot change within a process, and
    memory_stats() is a backend round-trip (per-file cost in the PANN prep
    path otherwise)."""
    limit = _device_hbm_bytes()
    if not limit or limit >= _KNEE_HBM_BYTES:
        return 1
    div = 1
    while limit < _KNEE_HBM_BYTES and div < 16:
        limit *= 2
        div *= 2
    return div


def pann_frame_cap() -> int:
    """PANN single-file frame cap, memory-scaled (the cap encodes 'block-1
    activations for ONE file fit alone', which shrinks with device memory)."""
    return PANN_MAX_FRAMES // hbm_batch_scale()


def bucket_len(n: int, minimum: int = 2048) -> int:
    """Round up to a 1/16-relative grid (grain 2^(floor(log2 n) - 4)):
    padding waste <= ~6% — padding is paid in transfer bytes AND in wasted
    frontend/CNN compute — while the distinct compiled shapes
    stay bounded (<= 17 per octave of file length; uniform-duration corpora,
    the common FAD case, compile exactly one)."""
    n = max(int(n), minimum)
    grain = 1 << max(11, n.bit_length() - 5)
    return ((n + grain - 1) // grain) * grain


def bucket_batch(n: int, cap: int) -> int:
    """Pad batch sizes to powers of two, clamped to ``cap``.

    The clamp applies below cap too: rounding a trailing chunk up past a
    non-power-of-two cap (e.g. 33 -> 64 with cap 43) would run a program
    up to ~2x the per-program activation footprint the cap was fitted to —
    an OOM risk on paths already at the memory knee (review r5). A
    cap-sized bucket adds no new compiled shape: the n >= cap branch
    already emits it."""
    if n >= cap:
        return cap
    return min(cap, 1 << (int(n - 1).bit_length() if n > 1 else 0))


def cast_model_params(family: str, params, dtype):
    """Cast a model's param pytree to the compute dtype (bfloat16 mode).

    Encodec runs MIXED precision: full bf16 is numerically unusable there
    (error compounds over the LSTM's ~750 sequential steps: FAD 918 vs 3e-4
    on identical dirs), so the LSTM and the final projection keep float32
    params and encodec_forward re-enters f32 at the LSTM (max |emb| error
    5e-4).
    """
    keep_f32 = {"lstm", "conv_out"} if family == "encodec" else set()

    def _cast(tree):
        if isinstance(tree, dict):
            return {k: (v if k in keep_f32 else _cast(v)) for k, v in tree.items()}
        if isinstance(tree, list):
            return [_cast(v) for v in tree]
        if hasattr(tree, "dtype") and jnp.issubdtype(tree.dtype, jnp.floating):
            return tree.astype(dtype)
        return tree

    return _cast(params)


# ---------------------------------------------------------------------------
# Fused per-chunk programs: ONE XLA executable per (frontend -> model) chunk,
# so the host issues one dispatch per chunk instead of a frontend jit, eager
# gather/slice/pad ops and a model jit (~10 dispatches, each a host round of
# Python and launch overhead), and the log-mel never leaves the program.
# ---------------------------------------------------------------------------


# The frontend+model section of each chunk program is built as a per-family
# "core" closure (pipeline._core, memoized per static shape). Under a data
# mesh the WHOLE core is shard_map-wrapped: per shard the batch is
# embarrassingly parallel, so the core runs unchanged on its slice with no
# collective. The streamed statistics fold stays OUTSIDE the shard_map
# (plain jit auto-partitions the masked reduction over the sharded rows).


def _mesh_wrap(core, mesh, n_sharded_args: int):
    """shard_map ``core(params, *batch_args)`` over the data axis (params
    replicated, every batch arg sharded on dim 0); identity without a mesh."""
    if mesh is None:
        return core
    from jax.sharding import PartitionSpec as P

    from .parallel.mesh import DATA_AXIS

    return jax.shard_map(
        core, mesh=mesh,
        in_specs=(P(),) + (P(DATA_AXIS),) * n_sharded_args,
        out_specs=P(DATA_AXIS),
    )


def _numerics_key() -> tuple:
    """The env knobs the frontends and models read while tracing
    (config.py). Part of every memoized core's key, so a mid-process flip
    of FAD_TPU_PRECISION (or an exactness force) builds a new core, which
    the step jits then trace afresh instead of serving the old program."""
    from .config import exactness_forced, lstm_op_dtype, matmul_precision

    return (matmul_precision(), exactness_forced(), lstm_op_dtype())


def _make_vggish_core(forward, num_patches: int, mesh):
    """[B, S] waveform -> [B, P, 128]: log-mel patches + CNN in one program.

    Computes ALL P = patches(bucket) rows per file; the host keeps each
    file's first P_i rows after the (tiny) fetch. The wasted tail compute is
    bounded by the ~6% bucket padding and is far cheaper than the extra
    dispatches of an on-device gather-select."""

    def core(params, wave):
        patches = fe.vggish_patches_batch(wave, num_patches, impl="auto")
        emb = forward(params, patches.reshape(-1, 96, 64))
        return emb.reshape(wave.shape[0], num_patches, -1)

    return _mesh_wrap(core, mesh, n_sharded_args=1)


def _make_mel_cnn_core(
    forward, target_sr: int, num_frames: int, i16_full_scale: float, mesh
):
    """Reflect-padded [B, L] waveform -> [B, d]: log-mel + CNN, one program."""

    def core(params, wave, n_valid):
        mel = fe.pann_logmel_batch(
            wave, target_sr, num_frames, n_valid, i16_full_scale=i16_full_scale
        )
        return forward(params, mel)

    return _mesh_wrap(core, mesh, n_sharded_args=2)


@functools.partial(jax.jit, static_argnames=("core",))
def _fused_vggish_step(params, wave, core):
    return core(params, wave)


@functools.partial(jax.jit, static_argnames=("core",))
def _fused_mel_cnn_step(params, wave, n_valid, core):
    return core(params, wave, n_valid)


# --- Fused chunk + streaming-stats programs (the device_stats sink path) ---
# Mask construction AND the (N, Σx, Σxxᵀ) update run inside the same XLA
# program as the frontend+model, so a sink chunk costs exactly one transfer +
# one dispatch (VERDICT r2 #7; previously: host mask build + a separate
# update_stats dispatch per chunk). ``state=None`` (a different pytree
# structure) selects the fused shift-init variant via jit's cache.


def _fold_stats(state, emb, mask):
    from .ops import stats as stats_ops

    emb = emb.astype(jnp.float32)
    if state is None:
        return stats_ops.init_update_stats(emb, mask)
    return stats_ops.update_stats(state, emb, mask)


@functools.partial(jax.jit, static_argnames=("core",))
def _fused_vggish_stats_step(params, wave, p_counts, state, core):
    """[B, S] waveform + per-file patch counts -> updated StreamingStats."""
    emb = core(params, wave)  # [B, P, d]
    mask = (jnp.arange(emb.shape[1])[None, :] < p_counts[:, None]).astype(jnp.float32)
    return _fold_stats(state, emb, mask)


@functools.partial(jax.jit, static_argnames=("core",))
def _fused_mel_cnn_stats_step(params, wave, n_valid, n_live, state, core):
    """Mel-CNN chunk + stats update; rows >= n_live are batch padding."""
    emb = core(params, wave, n_valid)
    mask = (jnp.arange(emb.shape[0]) < n_live).astype(jnp.float32)
    return _fold_stats(state, emb, mask)


@functools.partial(jax.jit, static_argnames=("forward",))
def _fused_encodec_stats_step(params, wave, frames, state, forward):
    """Encodec chunk + stats update; per-file valid frame counts mask the
    padded tail (the reference's trim-to-samples//320, fad.py:341-344)."""
    emb = forward(params, wave)  # [B, T, d]
    mask = (jnp.arange(emb.shape[1])[None, :] < frames[:, None]).astype(jnp.float32)
    return _fold_stats(state, emb, mask)


class StatsSink:
    """Sink marker: fold streaming statistics into the fused chunk programs
    (embeddings never leave the device; one dispatch per chunk)."""

    def __init__(self, state=None):
        self.state = state


class EmbeddingPipeline:
    """Embeds lists of (already decoded/resampled) waveforms for one model."""

    def __init__(
        self,
        model_name: str,
        params,
        file_batch: Optional[int] = None,
        patch_chunk: Optional[int] = None,
        verbose: bool = False,
    ):
        self.cfg = registry.get_model_config(model_name)
        self.params = params
        if file_batch is None:
            from .config import DEFAULT_FILE_BATCH

            # Explicit file_batch= arguments are the user's responsibility;
            # the default divides on devices with less memory.
            file_batch = max(1, DEFAULT_FILE_BATCH[self.cfg.family] // hbm_batch_scale())
        self.file_batch = file_batch
        self.mesh = None
        self._min_batch = 1
        self._core_cache = {}
        self._unmeshed_batching = None  # (file_batch, patch_chunk, _min_batch)
        if patch_chunk is None:
            # The vggish patch budget must admit file_batch full files
            # (10 s -> 10 patches each) for ANY file_batch, explicit ones
            # included; other families ignore it.
            patch_chunk = max(1024, self.file_batch * 10)
        self.patch_chunk = patch_chunk
        self.verbose = verbose
        from .utils.profiling import StageTimer

        self.timer = StageTimer()
        self._forward = self._resolve_forward()

        from .config import model_dtype

        dtype = model_dtype()
        if dtype != jnp.float32:
            # bfloat16 inference: cast weights once, cast inputs per call,
            # upcast outputs so statistics stay float32.
            self.params = cast_model_params(self.cfg.family, self.params, dtype)
            inner = self._forward
            cast_input = self.cfg.family != "encodec"  # encodec casts internally

            def bf16_forward(params, x, _inner=inner, _dtype=dtype, _ci=cast_input):
                if _ci:
                    x = x.astype(_dtype)
                return _inner(params, x).astype(jnp.float32)

            self._forward = bf16_forward

    def _resolve_forward(self) -> Callable:
        family = self.cfg.family
        if family == "vggish":
            from .models.vggish import vggish_forward

            return vggish_forward
        if family == "pann":
            from .models.pann import pann_forward

            return pann_forward
        if family == "encodec":
            from .models.encodec import encodec_forward

            causal = self.cfg.sample_rate == 24000
            return functools.partial(encodec_forward, causal=causal)
        if family == "clap":
            from .models.clap import clap_forward

            return clap_forward
        raise ValueError(f"Unknown family: {family}")

    # ------------------------------------------------------------------
    # Public entry points
    # ------------------------------------------------------------------

    def set_mesh(self, mesh) -> None:
        """Enable data-parallel execution over a 1-D 'data' mesh: params are
        replicated, file/patch batches are sharded over the mesh axis, and
        XLA propagates the sharding through every jitted stage (the batch
        dimension is embarrassingly parallel; the streamed statistics are the
        only cross-device reduction and live in parallel/embed.py)."""
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P

        # The vggish/pann/clap chunk programs are built via _core (the
        # frontend+model closure that gets shard_map-wrapped under a mesh).
        # Cores are cached per (mesh, numerics, shape key) — toggling a mesh
        # off (or re-setting the same one) reuses the already-jitted programs.
        self.mesh = mesh
        if mesh is not None:
            if self._unmeshed_batching is None:
                self._unmeshed_batching = (
                    self.file_batch, self.patch_chunk, self._min_batch
                )
            replicated = NamedSharding(mesh, P())
            self.params = jax.device_put(self.params, replicated)
            # Batch buckets must stay divisible by the mesh size.
            n = mesh.devices.size
            self.file_batch = max(self.file_batch, n)
            self.patch_chunk = max(self.patch_chunk, n)
            self._min_batch = n
        elif self._unmeshed_batching is not None:
            # Restore the pre-mesh batching so an unmeshed pipeline stops
            # padding trailing chunks to multiples of the old mesh size.
            self.file_batch, self.patch_chunk, self._min_batch = (
                self._unmeshed_batching
            )
            self._unmeshed_batching = None
            # Un-commit the params from the old mesh: leaving them device_put
            # with a replicated NamedSharding makes every post-unmesh jit
            # compile as a multi-device GSPMD program (redundant N-x compute)
            # — review r5.
            self.params = jax.device_put(self.params, jax.devices()[0])

    def _core(self, *key):
        """Memoized device-program body per (mesh, numerics, static-shape
        key) — a fresh closure per call would defeat the step jits'
        static-arg cache, and one shared across numerics settings would keep
        serving the program traced under the old settings (_numerics_key)."""
        full_key = (self.mesh, _numerics_key()) + key
        fn = self._core_cache.get(full_key)
        if fn is None:
            kind = key[0]
            if kind == "vggish":
                fn = _make_vggish_core(self._forward, key[1], self.mesh)
            elif kind == "mel":
                fn = _make_mel_cnn_core(self._forward, *key[1:], mesh=self.mesh)
            else:  # "encodec": the bare forward; under a mesh jit shards it
                fn = functools.partial(self._forward)
            self._core_cache[full_key] = fn
        return fn

    def _bucket_batch(self, n: int, cap: Optional[int] = None) -> int:
        # Round up to a multiple of the mesh size: power-of-two buckets alone
        # are not divisible by non-power-of-two meshes and device_put would
        # reject the sharding.
        from .parallel.mesh import pad_to_shards

        return pad_to_shards(bucket_batch(n, cap or self.file_batch), self._min_batch)

    def _to_device(self, arr: np.ndarray):
        """Host batch -> device array (sharded over 'data' when a mesh is set;
        callers guarantee batch dims are padded to power-of-two buckets >=
        the mesh size)."""
        import jax

        if self.mesh is None:
            return jnp.asarray(arr)
        from jax.sharding import NamedSharding, PartitionSpec as P

        spec = P("data", *([None] * (arr.ndim - 1)))
        return jax.device_put(arr, NamedSharding(self.mesh, spec))

    def embed_files(
        self, audio_list: List[np.ndarray], sr: int, strict: bool = False, sink=None
    ) -> List[Optional[np.ndarray]]:
        """Per-file embedding matrices, in input order.

        strict=False mirrors the reference's per-file error swallowing
        (reference: fad.py:400-403): a file whose preprocessing fails yields
        None instead of raising.

        sink: optional fn(rows_device [..., d], mask_host [...] | None) —
        when given, embedding rows are delivered on device (order
        unspecified, natural batch shape, mask as a host array to avoid
        per-chunk dispatches) and never copied to host; the return value
        holds per-file row counts instead of arrays.
        """
        family = self.cfg.family
        self._pbar = None
        if self.verbose and len(audio_list) > 1:
            from .utils.audio_io import progress_bar

            self._pbar = progress_bar(len(audio_list), desc=f"[FAD-TPU] {self.cfg.name}")
        try:
            with self.timer.stage(f"embed_files[{family}]"):
                if family == "vggish":
                    return self._embed_vggish(audio_list, sr, strict, sink)
                if family == "pann":
                    return self._embed_pann(audio_list, sr, strict, sink)
                if family == "clap":
                    return self._embed_clap(audio_list, sr, strict, sink)
                if family == "encodec":
                    return self._embed_encodec(audio_list, sr, strict, sink)
                raise ValueError(f"Unknown family: {family}")
        finally:
            if self._pbar is not None:
                self._pbar.close()
                self._pbar = None
            if self.verbose:
                print(self.timer.report())

    def _tick(self, n: int) -> None:
        if self._pbar is not None:
            self._pbar.update(n)

    def embed_single(self, audio: np.ndarray, sr: int) -> np.ndarray:
        """Single-file hook (reference: fad.py:410-481) — raises on error."""
        out = self.embed_files([audio], sr, strict=True)[0]
        return out

    def accumulate_stats(self, audio_list: List[np.ndarray], sr: int, state=None):
        """Single-pass on-device (N, Σx, Σxxᵀ) over all embedding rows —
        embeddings never leave the device.

        Uses the shift-stabilized streaming accumulator (ops.stats); the
        shift is the masked mean of the first delivered row batch. Pass the
        returned StreamingStats back as ``state`` to continue accumulating
        across chunks of a larger corpus (bounded host memory). Returns None
        if every file failed and no prior state was given.

        The whole update — mask construction included — runs inside the fused
        chunk program (StatsSink): one transfer + one dispatch per chunk.
        """
        sink = StatsSink(state)
        self.embed_files(audio_list, sr, strict=False, sink=sink)
        return sink.state

    # ------------------------------------------------------------------
    # Shared chunked model application
    # ------------------------------------------------------------------

    def _drain_pending(self, pending, per_file, trim):
        """Materialize deferred device chunks; trim(emb, row, file_idx) -> rows."""
        for chunk_idx, emb_dev in pending:
            emb = np.asarray(emb_dev)
            for row, i in enumerate(chunk_idx):
                per_file[i] = trim(emb, row, i)

    # ------------------------------------------------------------------
    # VGGish
    # ------------------------------------------------------------------

    def _embed_vggish(self, audio_list, sr, strict, sink=None):
        prepped: List[Optional[np.ndarray]] = []
        for audio in audio_list:
            try:
                data = np.asarray(audio)
                if data.ndim > 1:
                    data = np.mean(data, axis=1)
                if sr != fe.VGGISH_SAMPLE_RATE:
                    data = resample(data, sr, fe.VGGISH_SAMPLE_RATE)
                data = data.astype(np.float32)
                q = as_int16_exact(data)
                prepped.append(data if q is None else q)
            except Exception as e:
                if strict:
                    raise
                self._log_skip(e)
                prepped.append(None)

        # Group by waveform bucket; compute patches per group.
        per_file: List[Optional[np.ndarray]] = [None] * len(audio_list)
        # Long files are split at patch boundaries so no single XLA program
        # sees more than ~patch_chunk patches (bounded activation footprint).
        # VGGish framing is uncentered, so a segment starting at sample
        # 160*96*k0 and ending at 160*(96*k1 - 1) + 400 reproduces exactly
        # frames [96*k0, 96*k1) of the full file — the split is numerically
        # invisible. Work items are (file_idx, segment_order, samples).
        seg_hop = fe.VGGISH_HOP * fe.VGGISH_PATCH_FRAMES  # samples per patch
        items: List[Tuple[int, int, np.ndarray]] = []
        for i, data in enumerate(prepped):
            if data is None:
                continue
            p = fe.vggish_num_patches(len(data))
            if p == 0:
                # Audio shorter than one 0.96 s patch: zero rows, like the
                # reference's tail-dropping framing (models/vggish.py:263-271
                # yields an empty [0, 128] embedding, not an error).
                per_file[i] = (
                    0 if sink is not None
                    else np.zeros((0, self.cfg.embedding_dim), np.float32)
                )
                self._tick(1)
                continue
            if p <= self.patch_chunk:
                items.append((i, 0, data))
            else:
                for seg, k0 in enumerate(range(0, p, self.patch_chunk)):
                    k1 = min(p, k0 + self.patch_chunk)
                    end = len(data) if k1 == p else (
                        fe.VGGISH_HOP * (fe.VGGISH_PATCH_FRAMES * k1 - 1) + fe.VGGISH_WINDOW
                    )
                    items.append((i, seg, data[seg_hop * k0 : end]))

        groups: Dict[int, List[int]] = {}
        for idx, (_, _, seg_data) in enumerate(items):
            groups.setdefault(bucket_len(len(seg_data)), []).append(idx)

        parts: Dict[int, Dict[int, np.ndarray]] = {}
        counts: Dict[int, int] = {}
        pending = []
        for s_bucket, idxs in sorted(groups.items()):
            p_max = fe.vggish_num_patches(s_bucket)
            # Cap files per program so the CNN batch (b * p_max patches)
            # stays within a bounded activation footprint.
            b_cap = max(
                self._min_batch, min(self.file_batch, max(1, self.patch_chunk // p_max))
            )
            for c0 in range(0, len(idxs), b_cap):
                chunk = [items[j] for j in idxs[c0 : c0 + b_cap]]
                b = self._bucket_batch(len(chunk), cap=b_cap)
                wave = _pack_wave([seg for _, _, seg in chunk], b, s_bucket)
                p_counts = [fe.vggish_num_patches(len(seg)) for _, _, seg in chunk]
                if isinstance(sink, StatsSink):
                    p_arr = np.zeros((b,), np.int32)
                    p_arr[: len(p_counts)] = p_counts
                    sink.state = _fused_vggish_stats_step(
                        self.params, self._to_device(wave), jnp.asarray(p_arr),
                        sink.state, self._core("vggish", p_max),
                    )
                    for (i, _, _), count in zip(chunk, p_counts):
                        counts[i] = counts.get(i, 0) + count
                else:
                    emb_dev = _fused_vggish_step(
                        self.params, self._to_device(wave),
                        self._core("vggish", p_max),
                    )  # [b, p_max, 128]
                    if sink is not None:
                        mask = np.zeros((b, p_max), np.float32)
                        for row, count in enumerate(p_counts):
                            mask[row, :count] = 1.0
                        sink(emb_dev, mask)
                        for (i, _, _), count in zip(chunk, p_counts):
                            counts[i] = counts.get(i, 0) + count
                    else:
                        pending.append((chunk, p_counts, emb_dev))
                self._tick(sum(1 for _, seg, _ in chunk if seg == 0))
        # Materialize after all dispatches (device work overlaps host packing).
        for chunk, p_counts, emb_dev in pending:
            emb = np.asarray(emb_dev)
            for row, ((i, seg, _), count) in enumerate(zip(chunk, p_counts)):
                parts.setdefault(i, {})[seg] = emb[row, :count]
        for i, segs in parts.items():
            per_file[i] = np.concatenate([segs[k] for k in sorted(segs)], axis=0)
        for i, count in counts.items():
            per_file[i] = count
        return per_file

    # ------------------------------------------------------------------
    # PANN
    # ------------------------------------------------------------------

    def _embed_mel_cnn(
        self, audio_list, strict, sink, prep_fn, group_key_fn, plan_fn,
        i16_full_scale: float = 32768.0,
    ):
        """Shared scaffold for the mel-frontend CNN families (PANN, CLAP).

        prep_fn(audio) -> (reflect_padded_wave, n_valid_frames); the wave may
            be int16 on the k/i16_full_scale grid (PCM16-exact fast path)
        group_key_fn(item) -> static-shape group key
        plan_fn(key) -> (buffer_len, target_sample_rate, num_frames)
        """
        prepped: List[Optional[Tuple[np.ndarray, int]]] = []
        for audio in audio_list:
            try:
                prepped.append(prep_fn(np.asarray(audio)))
            except Exception as e:
                if strict:
                    raise
                self._log_skip(e)
                prepped.append(None)

        groups: Dict[int, List[int]] = {}
        for i, item in enumerate(prepped):
            if item is None:
                continue
            groups.setdefault(group_key_fn(item), []).append(i)

        per_file: List[Optional[np.ndarray]] = [None] * len(audio_list)
        pending = []
        for key, idxs in sorted(groups.items()):
            length, target_sr, num_frames = plan_fn(key)
            # Bound the per-program activation footprint: the CNN's widest
            # intermediate scales with b * num_frames, so long files shrink
            # the batch. The frame budget scales with file_batch (explicit
            # and mesh-raised choices take effect); file_batch x ~1032
            # frames is the measured-good per-program operating point.
            b_cap = max(
                self._min_batch,
                min(self.file_batch, max(1, (self.file_batch * 1032) // num_frames)),
            )
            for c0 in range(0, len(idxs), b_cap):
                chunk_idx = idxs[c0 : c0 + b_cap]
                b = self._bucket_batch(len(chunk_idx), cap=b_cap)
                wave = _pack_wave(
                    [prepped[i][0] for i in chunk_idx], b, length, i16_full_scale
                )
                n_valid = np.zeros((b,), dtype=np.int32)
                for row, i in enumerate(chunk_idx):
                    n_valid[row] = prepped[i][1]
                core = self._core("mel", target_sr, num_frames, i16_full_scale)
                if isinstance(sink, StatsSink):
                    sink.state = _fused_mel_cnn_stats_step(
                        self.params, self._to_device(wave), n_valid,
                        jnp.asarray(len(chunk_idx), jnp.int32), sink.state, core,
                    )
                    for i in chunk_idx:
                        per_file[i] = 1
                else:
                    emb_dev = _fused_mel_cnn_step(
                        self.params, self._to_device(wave), n_valid, core,
                    )
                    if sink is not None:
                        # Full batch + mask for the padded rows: no eager slice.
                        row_mask = np.zeros((b,), np.float32)
                        row_mask[: len(chunk_idx)] = 1.0
                        sink(emb_dev, row_mask)
                        for i in chunk_idx:
                            per_file[i] = 1
                    else:
                        pending.append((chunk_idx, emb_dev))
                self._tick(len(chunk_idx))
        # Convert after all dispatches so XLA execution overlaps host packing.
        self._drain_pending(pending, per_file, lambda emb, row, i: emb[row : row + 1])
        return per_file

    def _embed_pann(self, audio_list, sr, strict, sink=None):
        target_sr = self.cfg.sample_rate
        cfg = fe.PANN_CONFIGS[target_sr]
        n_fft, hop = cfg["window_size"], cfg["hop_size"]

        def prep(data):
            if data.ndim > 1:
                data = np.mean(data, axis=1)
            if sr != target_sr:
                data = resample(data, sr, target_sr)
            data = data.astype(np.float32)
            t_i = fe.pann_num_frames(len(data), hop)
            if fe.pann_valid_time(t_i) < 40:
                # The CNN needs time/32 >= 1 after five floor-halving pools;
                # the torch reference errors out on such inputs too.
                raise ValueError(
                    f"Audio too short for PANN (grid {fe.pann_valid_time(t_i)} < 40 frames)"
                )
            frame_cap = pann_frame_cap()
            if t_i > frame_cap:
                raise ValueError(
                    f"Audio too long for PANN ({t_i} log-mel frames > "
                    f"{frame_cap}): a single file's activations would "
                    f"exceed device memory. Split the file (PANN embeds one "
                    f"row per file, so scoring chunks separately changes the "
                    f"statistics rows, like the reference's >100 s guidance)."
                )
            padded = fe.reflect_pad_host(data, n_fft)
            q = as_int16_exact(padded)
            return (padded if q is None else q), t_i

        return self._embed_mel_cnn(
            audio_list, strict, sink,
            prep_fn=prep,
            # The 32k-24 grid is observable in the embedding: never mix grids.
            group_key_fn=lambda item: fe.pann_valid_time(item[1]),
            plan_fn=lambda t_grid: (t_grid * hop + n_fft, target_sr, t_grid),
        )

    # ------------------------------------------------------------------
    # CLAP
    # ------------------------------------------------------------------

    def _embed_clap(self, audio_list, sr, strict, sink=None):
        n_fft = fe.PANN_CONFIGS[fe.CLAP_SAMPLE_RATE]["window_size"]

        def prep(data):
            if data.ndim > 1:
                # Mono-mix BEFORE the 10 s pad. The reference's score() path
                # always receives mono from load_audio; for direct 2-D
                # get_embeddings input its np.pad(audio, (0, k)) zero-pads
                # the CHANNEL axis too and then mono-mixes over C+k channels
                # (near-silence) — rank-confusion of the load_audio class,
                # not behavior worth preserving (PARITY.md quirks).
                data = np.mean(data, axis=1)
            # Files longer than the CLAP mel read window ship truncated: the
            # reference supports long audio by TRUNCATING the mel to 1001
            # frames (fad.py:69-91), and frames 0..1000 of a center/reflect
            # STFT depend only on target samples < (1001+2)*480 = 481,440 —
            # so the prefix that reaches the model is bit-identical while
            # the wire/pad bytes and one XLA compile per length bucket are
            # saved (code-review r5). The resampler's Kaiser kernel has
            # finite support; 4096 source samples of margin keep the
            # resampled prefix bitwise too.
            need = (fe.CLAP_TIME_FRAMES + 2) * 480
            if sr != fe.CLAP_SAMPLE_RATE:
                need = int(np.ceil(need * sr / fe.CLAP_SAMPLE_RATE)) + 4096
            if len(data) > need:
                data = data[:need]
            # Pad the *waveform* before the mel (reference: fad.py:354-359),
            # then quantize (zeros are fixed points). The reference pads to
            # 480000 samples at the SOURCE rate; for sr < 48 kHz that is
            # 3-6x more zeros than the 1001-frame mel can ever read, so the
            # pad target is capped at the read window (`need`) — bitwise
            # identical for frames 0..1000 by the same finite-filter-support
            # prefix argument as the truncation above, while resampling and
            # shipping 3x less (review r5). For sr >= 48 kHz need > 480000,
            # so the reference's pad semantics are unchanged there.
            pad_target = min(fe.CLAP_MAX_SAMPLES, need)
            if len(data) < pad_target:
                data = np.pad(data, (0, pad_target - len(data)))
            data = data.astype(np.float32)
            data = (data * 32767.0).astype(np.int16).astype(np.float32) / 32767.0
            if sr != fe.CLAP_SAMPLE_RATE:
                data = resample(data, sr, fe.CLAP_SAMPLE_RATE).astype(np.float32)
            # Frames beyond the (resampled) signal must be 0.0 rows like the
            # reference's mel zero-pad (fad.py:69-91) — relevant when
            # sr > 48 kHz shrinks the padded waveform below 10 s.
            n_valid = min(fe.CLAP_TIME_FRAMES, fe.pann_num_frames(len(data), 480))
            padded = fe.reflect_pad_host(data, n_fft)
            # The int16 quantization above puts samples on the k/32767 grid,
            # so the no-resample case always ships int16.
            q = as_int16_exact(padded, 32767.0)
            return (padded if q is None else q), n_valid

        return self._embed_mel_cnn(
            audio_list, strict, sink,
            prep_fn=prep,
            group_key_fn=lambda item: bucket_len(len(item[0])),
            plan_fn=lambda s_bucket: (s_bucket, fe.CLAP_SAMPLE_RATE, fe.CLAP_TIME_FRAMES),
            i16_full_scale=32767.0,
        )

    # ------------------------------------------------------------------
    # Encodec
    # ------------------------------------------------------------------

    def _embed_encodec(self, audio_list, sr, strict, sink=None):
        target_sr = self.cfg.sample_rate
        config = fe.ENCODEC_CONFIGS[target_sr]
        channels, hop = config["channels"], config["hop_length"]
        max_samples = config["max_samples"]

        prepped: List[Optional[Tuple[np.ndarray, int]]] = []
        for audio in audio_list:
            try:
                audio = np.asarray(audio)
                # Original length for output trimming (reference: fad.py:324-328).
                if sr != target_sr:
                    original_samples = int(len(audio) * target_sr / sr)
                else:
                    original_samples = len(audio)
                pre = fe.preprocess_for_encodec(
                    audio, sr, target_sample_rate=target_sr,
                    target_channels=channels, return_tensor=False,
                )  # [C, S]
                if pre.shape[-1] > max_samples:
                    raise ValueError(
                        f"Audio too long: {pre.shape[-1]} samples > {max_samples} max samples"
                    )
                q = as_int16_exact(pre)
                prepped.append((pre if q is None else q, original_samples // hop))
            except Exception as e:
                if strict:
                    raise
                self._log_skip(e)
                prepped.append(None)

        idxs = [i for i, p in enumerate(prepped) if p is not None]
        per_file: List[Optional[np.ndarray]] = [None] * len(audio_list)
        pending = []
        forward = self._core("encodec")
        for c0 in range(0, len(idxs), self.file_batch):
            chunk_idx = idxs[c0 : c0 + self.file_batch]
            b = self._bucket_batch(len(chunk_idx))
            wave = _pack_wave([prepped[i][0] for i in chunk_idx], b, max_samples)
            frames = np.zeros((b,), np.int32)
            for row, i in enumerate(chunk_idx):
                frames[row] = prepped[i][1]
                per_file[i] = prepped[i][1]
            if isinstance(sink, StatsSink):
                sink.state = _fused_encodec_stats_step(
                    self.params, self._to_device(wave), jnp.asarray(frames),
                    sink.state, forward,
                )
            else:
                emb_dev = forward(self.params, self._to_device(wave))  # [B, T, 128]
                if sink is not None:
                    t = emb_dev.shape[1]
                    mask = (np.arange(t)[None, :] < frames[:, None]).astype(np.float32)
                    sink(emb_dev, mask)
                else:
                    pending.append((chunk_idx, emb_dev))
            self._tick(len(chunk_idx))
        self._drain_pending(pending, per_file, lambda emb, row, i: emb[row, : prepped[i][1]])
        return per_file

    def _log_skip(self, e: Exception) -> None:
        if self.verbose:
            print(f"[FAD-TPU] Error processing audio: {e}")
