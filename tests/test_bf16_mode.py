"""bfloat16 inference mode (FAD_TPU_MODEL_DTYPE=bfloat16): runs end to end,
stays close to the float32 path, and keeps statistics float32."""

import numpy as np
import pytest


def test_bf16_vggish_close_to_f32(monkeypatch, sine_audio):
    from frechet_audio_distance_exported_tpu import FrechetAudioDistance

    clips = [sine_audio(2.0, 440.0), sine_audio(2.0, 880.0)]

    fad32 = FrechetAudioDistance(model_name="vggish", weights="random")
    e32 = fad32.get_embeddings(clips, 16000)

    monkeypatch.setenv("FAD_TPU_MODEL_DTYPE", "bfloat16")
    fad16 = FrechetAudioDistance(model_name="vggish", weights="random")
    e16 = fad16.get_embeddings(clips, 16000)

    assert e16.dtype == np.float32  # upcast at the boundary
    assert e16.shape == e32.shape
    # bfloat16 has ~3 decimal digits; embeddings should agree loosely.
    denom = np.maximum(np.abs(e32), 1e-3)
    rel = np.abs(e16 - e32) / denom
    assert np.median(rel) < 0.1, np.median(rel)


def test_unflatten_gapped_digit_keys_stay_dicts():
    """Gapped or zero-padded all-digit keys must not be list-ified (the old
    contiguous-range comprehension raised KeyError on 'layers/1' gaps)."""
    import numpy as np

    from frechet_audio_distance_exported_tpu.utils.weights import unflatten_params

    flat = {"layers/0/w": np.ones(2), "layers/2/w": np.ones(2), "pad/01/w": np.ones(2)}
    tree = unflatten_params(flat)
    assert isinstance(tree["layers"], dict) and set(tree["layers"]) == {"0", "2"}
    assert isinstance(tree["pad"], dict)
    # Contiguous keys still become lists.
    tree2 = unflatten_params({"b/0/w": np.ones(2), "b/1/w": np.ones(2)})
    assert isinstance(tree2["b"], list) and len(tree2["b"]) == 2


def test_corrupt_bundle_raises_actionable_error(tmp_path):
    import pytest as _pytest

    from frechet_audio_distance_exported_tpu.utils.weights import get_params

    bad = tmp_path / "vggish_weights.npz"
    bad.write_bytes(b"not a zip")
    from frechet_audio_distance_exported_tpu import registry

    name = registry.get_model_config("vggish").weight_filename
    (tmp_path / name).write_bytes(b"not a zip")
    with _pytest.raises(RuntimeError, match="failed to load"):
        get_params("vggish", str(tmp_path))


def test_model_dtype_platform_default(monkeypatch):
    """Unset, the model dtype is float32 (one policy for every platform,
    config.py). The env var forces either."""
    import jax.numpy as jnp

    from frechet_audio_distance_exported_tpu.config import model_dtype

    monkeypatch.delenv("FAD_TPU_MODEL_DTYPE", raising=False)
    assert model_dtype() == jnp.float32
    monkeypatch.setenv("FAD_TPU_MODEL_DTYPE", "bfloat16")
    assert model_dtype() == jnp.bfloat16
    monkeypatch.setenv("FAD_TPU_MODEL_DTYPE", "float32")
    assert model_dtype() == jnp.float32


def test_model_dtype_rejects_typos(monkeypatch):
    """A typo'd FAD_TPU_MODEL_DTYPE must raise, not silently fall through to
    the platform default (which would also defeat the encodec-48k opt-in)."""
    import pytest as _pytest

    from frechet_audio_distance_exported_tpu.config import model_dtype

    monkeypatch.setenv("FAD_TPU_MODEL_DTYPE", "fp16")
    with _pytest.raises(ValueError, match="FAD_TPU_MODEL_DTYPE"):
        model_dtype()


def test_lstm_op_dtype_resolution(monkeypatch):
    """The Encodec recurrent-matmul operand dtype: env override wins; an
    explicit full-f32 force (FAD_TPU_MODEL_DTYPE=float32 or
    FAD_TPU_PRECISION=highest) keeps it float32; typos raise; the default
    is float32."""
    import jax.numpy as jnp
    import pytest as _pytest

    from frechet_audio_distance_exported_tpu.config import lstm_op_dtype

    for var in ("FAD_TPU_LSTM_MATMUL", "FAD_TPU_MODEL_DTYPE", "FAD_TPU_PRECISION"):
        monkeypatch.delenv(var, raising=False)
    assert lstm_op_dtype() == jnp.float32
    monkeypatch.setenv("FAD_TPU_LSTM_MATMUL", "bf16")
    assert lstm_op_dtype() == jnp.bfloat16
    # The explicit knob outranks the full-f32 forces.
    monkeypatch.setenv("FAD_TPU_MODEL_DTYPE", "float32")
    assert lstm_op_dtype() == jnp.bfloat16
    monkeypatch.delenv("FAD_TPU_LSTM_MATMUL")
    assert lstm_op_dtype() == jnp.float32  # forced full-f32
    monkeypatch.delenv("FAD_TPU_MODEL_DTYPE")
    monkeypatch.setenv("FAD_TPU_PRECISION", "highest")
    assert lstm_op_dtype() == jnp.float32  # bitwise-closest mode
    monkeypatch.delenv("FAD_TPU_PRECISION")
    monkeypatch.setenv("FAD_TPU_LSTM_MATMUL", "int8")
    with _pytest.raises(ValueError, match="FAD_TPU_LSTM_MATMUL"):
        lstm_op_dtype()


def test_clap_env_flip_retraces(monkeypatch):
    """FAD_TPU_PRECISION resolves at call time and sits in
    clap_forward's jit key — a mid-process flip must add a trace-cache entry
    instead of reusing the stale branch (code-review r5; on CPU outputs can
    be bitwise-equal, so assert the mechanism)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from frechet_audio_distance_exported_tpu.models import clap

    monkeypatch.delenv("FAD_TPU_PRECISION", raising=False)
    params = clap.init_clap_params(jax.random.PRNGKey(0))
    mel = jax.random.normal(jax.random.PRNGKey(1), (1, 1001, 64), jnp.float32)
    base = np.asarray(clap.clap_forward(params, mel))
    size0 = clap._clap_forward_jit._cache_size()
    monkeypatch.setenv("FAD_TPU_PRECISION", "highest")
    hi = np.asarray(clap.clap_forward(params, mel))
    size1 = clap._clap_forward_jit._cache_size()
    assert size1 > size0, "precision flip reused the stale trace"
    np.testing.assert_allclose(hi, base, rtol=0, atol=1e-5)


def test_pipeline_programs_rekey_on_precision_flip(monkeypatch):
    """The fused chunk programs trace the frontends and models inside one
    outer jit, so a FAD_TPU_PRECISION flip reaches them only through the
    memoized core's key: a core shared across settings kept serving the
    program traced under the old precision."""
    import jax

    from frechet_audio_distance_exported_tpu import pipeline as pl
    from frechet_audio_distance_exported_tpu.models.vggish import init_vggish_params

    monkeypatch.delenv("FAD_TPU_PRECISION", raising=False)
    pipe = pl.EmbeddingPipeline("vggish", init_vggish_params(jax.random.PRNGKey(0)))
    clips = [np.random.default_rng(0).standard_normal(16000).astype(np.float32) * 0.1]
    pipe.embed_files(clips, 16000)
    core0, size0 = pipe._core("vggish", 1), pl._fused_vggish_step._cache_size()
    monkeypatch.setenv("FAD_TPU_PRECISION", "highest")
    assert pipe._core("vggish", 1) is not core0
    pipe.embed_files(clips, 16000)
    assert pl._fused_vggish_step._cache_size() > size0, "precision flip reused the stale program"
    enc = pl.EmbeddingPipeline("encodec-24k", params={})
    enc_hi = enc._core("encodec")
    monkeypatch.delenv("FAD_TPU_PRECISION")
    assert pipe._core("vggish", 1) is core0  # back to the original program
    assert enc._core("encodec") is not enc_hi


def test_attn_mode_is_a_static_arg_not_a_global():
    """No process-wide mesh or attention global: clap_forward takes only
    params and log-mels, so meshed and unmeshed CLAP pipelines coexist in
    one process. Under a mesh the pipeline rebuilds its frontend+model core
    shard_map-wrapped (pipeline._core) and set_mesh(None) restores the
    plain cores."""
    import inspect

    import jax

    from frechet_audio_distance_exported_tpu.models import clap
    from frechet_audio_distance_exported_tpu.parallel.mesh import data_mesh
    from frechet_audio_distance_exported_tpu.pipeline import EmbeddingPipeline

    assert list(inspect.signature(clap.clap_forward).parameters) == ["params", "log_mel"]

    pipe = EmbeddingPipeline("clap", clap.init_clap_params(jax.random.PRNGKey(0)))
    key = ("mel", 48000, 1001, 32767.0)
    base_core = pipe._core(*key)
    assert pipe._core(*key) is base_core  # memoized per static key
    pipe.set_mesh(data_mesh())
    meshed_core = pipe._core(*key)
    assert meshed_core is not base_core  # rebuilt shard_map-wrapped
    assert pipe._core(*key) is meshed_core
    pipe.set_mesh(None)
    # Untoggling restores the ORIGINAL cached core (and its jitted programs).
    assert pipe._core(*key) is base_core
    # ...and un-commits the params from the old mesh: leaving them replicated
    # across it would make every post-unmesh jit a multi-device GSPMD
    # program (review r5).
    leaves = jax.tree_util.tree_leaves(pipe.params)
    assert all(len(leaf.sharding.device_set) == 1 for leaf in leaves)


def test_bf16_encodec_mixed_precision(monkeypatch):
    """Encodec in bf16 mode runs MIXED precision: conv stages bf16, LSTM and
    conv_out float32 (full bf16 compounds error over ~750 recurrence steps).
    Embeddings must stay close to the f32 path — the round-2 full-bf16 mode
    produced order-1 embedding errors; mixed stays ~1e-4."""
    import jax
    import numpy as np

    from frechet_audio_distance_exported_tpu.models.encodec import init_encodec_params
    from frechet_audio_distance_exported_tpu.pipeline import EmbeddingPipeline

    rng = np.random.RandomState(0)
    clips = [rng.randn(24000 * 2).astype(np.float32) * 0.1 for _ in range(2)]
    params = init_encodec_params(jax.random.PRNGKey(0), causal=True, channels=1)

    p32 = EmbeddingPipeline("encodec-24k", params)
    e32 = np.concatenate(p32.embed_files(clips, 24000), axis=0)

    monkeypatch.setenv("FAD_TPU_MODEL_DTYPE", "bfloat16")
    p16 = EmbeddingPipeline("encodec-24k", params)
    # LSTM and conv_out params must not have been downcast.
    leaves = jax.tree_util.tree_leaves(p16.params["lstm"])
    assert all(l.dtype == np.float32 for l in leaves)
    assert p16.params["conv_out"]["w"].dtype == np.float32
    assert p16.params["conv_in"]["w"].dtype == "bfloat16"

    e16 = np.concatenate(p16.embed_files(clips, 24000), axis=0)
    assert e16.dtype == np.float32
    err = np.abs(e32 - e16)
    assert err.max() < 5e-3, err.max()
    assert err.mean() < 5e-4, err.mean()


def test_bf16_identical_dirs_zero(monkeypatch, tmp_path, sine_audio):
    import os

    from frechet_audio_distance_exported_tpu import FrechetAudioDistance
    from frechet_audio_distance_exported_tpu.utils.audio_io import write_wav

    monkeypatch.setenv("FAD_TPU_MODEL_DTYPE", "bfloat16")
    d = tmp_path / "bg"
    os.makedirs(d)
    for i in range(3):
        write_wav(str(d / f"{i}.wav"), sine_audio(1.5, 440.0 + 5 * i), 16000)
    fad = FrechetAudioDistance(model_name="vggish", weights="random")
    assert abs(fad.score(str(d), str(d))) < 1e-3
