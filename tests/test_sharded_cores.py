"""The shard_map-wrapped frontend+model cores (pipeline._mesh_wrap, with
jax's varying-manual-axes check on) over 8 virtual CPU devices give the
unsharded cores' embeddings: one row per device, full model width."""

import numpy as np
import pytest


def _cores(make, *args):
    import jax

    from frechet_audio_distance_exported_tpu.parallel.mesh import data_mesh

    mesh = data_mesh(jax.devices()[:8])
    return jax.jit(make(*args, mesh=None)), jax.jit(make(*args, mesh=mesh)), mesh


def _sharded(mesh, x):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    spec = P("data", *([None] * (x.ndim - 1)))
    return jax.device_put(x, NamedSharding(mesh, spec))


@pytest.mark.parametrize("model", ["vggish", "pann-16k", "clap"])
def test_sharded_core_matches_unsharded(model):
    import jax

    from frechet_audio_distance_exported_tpu import pipeline as pl
    from frechet_audio_distance_exported_tpu import registry
    from frechet_audio_distance_exported_tpu.ops import frontends as fe
    from frechet_audio_distance_exported_tpu.utils.weights import init_random_params

    assert len(jax.devices()) >= 8, "conftest provides 8 virtual CPU devices"
    cfg = registry.get_model_config(model)
    forward = pl.EmbeddingPipeline(model, params={})._forward
    params = init_random_params(model, seed=0)
    rng = np.random.default_rng(0)
    b = 8
    if cfg.family == "vggish":
        s = fe.VGGISH_WINDOW + (2 * fe.VGGISH_PATCH_FRAMES - 1) * fe.VGGISH_HOP  # 2 patches
        wave = (0.1 * rng.standard_normal((b, s))).astype(np.float32)
        plain, meshed, mesh = _cores(pl._make_vggish_core, forward, 2)
        want = plain(params, wave)
        got = meshed(params, _sharded(mesh, wave))
    else:
        sr = cfg.sample_rate if cfg.family == "pann" else fe.CLAP_SAMPLE_RATE
        n_fft, hop = fe.PANN_CONFIGS[sr]["window_size"], fe.PANN_CONFIGS[sr]["hop_size"]
        if cfg.family == "pann":
            num_frames, full_scale = fe.pann_valid_time(fe.pann_num_frames(sr, hop)), 32768.0
        else:
            num_frames, full_scale = fe.CLAP_TIME_FRAMES, 32767.0
        wave = (0.1 * rng.standard_normal((b, num_frames * hop + n_fft))).astype(np.float32)
        # Per-row valid frame counts, so the masking differs across shards.
        n_valid = (num_frames - 3 * np.arange(b)).astype(np.int32)
        plain, meshed, mesh = _cores(pl._make_mel_cnn_core, forward, sr, num_frames, full_scale)
        want = plain(params, wave, n_valid)
        got = meshed(params, _sharded(mesh, wave), _sharded(mesh, n_valid))
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.shape[0] == b
    assert got.shape[-1] == cfg.embedding_dim
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
