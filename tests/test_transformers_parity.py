"""Architecture parity vs HuggingFace transformers' independent CLAP/EnCodec
implementations (third-party code, not replicas written alongside the JAX
models — see VERDICT r1 #8). Random weights are transferred through
tools/from_transformers.py and the forwards compared.

transformers' defaults ARE the variants the reference uses: ClapAudioConfig
defaults = HTSAT-tiny (depths [2,2,6,2], window 8, embed 96, spec 256,
64 mel bins); EncodecConfig defaults = encodec_24khz (ratios [8,5,4,2],
causal, weight_norm, 2-layer LSTM).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent / "tools"))

import from_transformers as conv  # noqa: E402

from frechet_audio_distance_exported_tpu.models.clap import clap_forward  # noqa: E402
from frechet_audio_distance_exported_tpu.models.encodec import encodec_forward  # noqa: E402


class TestEncodecVsTransformers:
    @pytest.mark.parametrize(
        "variant,channels,samples",
        [("24k", 1, 2400), ("48k", 2, 4800)],
    )
    def test_encoder_matches(self, variant, channels, samples):
        from transformers import EncodecConfig, EncodecModel

        if variant == "24k":
            cfg = EncodecConfig()  # causal, weight_norm, mono
            causal = True
        else:
            cfg = EncodecConfig(
                norm_type="time_group_norm", use_causal_conv=False,
                audio_channels=2, sampling_rate=48000,
            )
            causal = False
        torch.manual_seed(0)
        model = EncodecModel(cfg).eval()
        params = conv.convert_encodec(model)

        rng = np.random.default_rng(1)
        wave = rng.standard_normal((2, channels, samples)).astype(np.float32) * 0.3

        with torch.no_grad():
            ref = model.encoder(torch.from_numpy(wave)).numpy()  # [B, 128, T]
        ours = np.asarray(encodec_forward(params, wave, causal=causal))  # [B, T, 128]

        assert ours.shape == (2, ref.shape[2], 128)
        np.testing.assert_allclose(
            ours, ref.transpose(0, 2, 1), rtol=1e-4, atol=2e-4,
        )


class TestClapVsTransformers:
    @pytest.fixture(scope="class")
    def hf_model(self):
        from transformers import ClapAudioConfig, ClapAudioModelWithProjection

        torch.manual_seed(0)
        return ClapAudioModelWithProjection(ClapAudioConfig()).eval()

    @pytest.fixture(scope="class")
    def mel(self):
        rng = np.random.default_rng(2)
        # Plausible log-mel dB scale.
        return (rng.standard_normal((2, 1001, 64)) * 10.0 - 20.0).astype(np.float32)

    def test_audio_embedding_matches(self, hf_model, mel):
        params = conv.convert_clap(hf_model)
        with torch.no_grad():
            out = hf_model(input_features=torch.from_numpy(mel[:, None]))
        ref = out.audio_embeds.numpy()  # projected, not normalized
        ref = ref / np.linalg.norm(ref, axis=-1, keepdims=True)

        ours = np.asarray(clap_forward(params, mel))

        assert ours.shape == (2, 512)
        cos = np.sum(ours * ref, axis=-1)
        assert np.all(cos > 0.9999), cos
        np.testing.assert_allclose(ours, ref, rtol=1e-3, atol=5e-4)

    def test_pre_projection_latent_matches(self, hf_model, mel):
        """The 768-d pooled latent (HTSAT avgpool) must equal our token mean —
        validating the latent-regrouping == token-mean claim in models/clap.py
        against third-party code."""
        from frechet_audio_distance_exported_tpu.models import clap as clap_mod
        from frechet_audio_distance_exported_tpu.models import common
        import jax.numpy as jnp

        params = conv.convert_clap(hf_model)
        with torch.no_grad():
            pooled = hf_model.audio_model(
                input_features=torch.from_numpy(mel[:, None])
            ).pooler_output.numpy()  # [B, 768]

        # Re-run our forward up to the token mean (mirror clap_forward's tail).
        x = jnp.asarray(mel)
        interp = jnp.asarray(clap_mod._bicubic_time_matrix(1001, clap_mod.TARGET_T))
        h = jnp.einsum("ot,btf->bof", interp, x)
        h = common.batch_norm(h, params["bn0"])
        b = h.shape[0]
        h = h.reshape(b, 4, 256, 64)
        h = jnp.transpose(h, (0, 1, 3, 2)).reshape(b, 256, 256)[..., None]
        pe = params["patch_embed"]
        h = common.conv2d(h, pe["conv"]["w"], pe["conv"]["b"], stride=(4, 4), padding="VALID")
        h = h.reshape(b, -1, 96)
        h = common.layer_norm(h, **pe["norm"])
        for i, stage in enumerate(params["stages"]):
            res, heads = clap_mod._STAGE_RES[i], clap_mod.NUM_HEADS[i]
            for j, blk in enumerate(stage["blocks"]):
                shift = 0 if (j % 2 == 0 or res <= clap_mod.WINDOW_SIZE) else clap_mod.WINDOW_SIZE // 2
                h = clap_mod._swin_block(blk, h, res, heads, shift)
            if "downsample" in stage:
                h = clap_mod._patch_merging(stage["downsample"], h, res)
        h = common.layer_norm(h, **params["norm"])
        ours = np.asarray(jnp.mean(h, axis=1))

        np.testing.assert_allclose(ours, pooled, rtol=1e-3, atol=5e-4)
