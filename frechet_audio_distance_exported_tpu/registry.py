"""Model registry: names, sample rates, embedding dims, weight artifacts.

Re-design of the reference registry (reference: fad.py:95-130).
The reference maps model names to torch .pt2/.pt artifacts downloaded from
GitHub releases; here each model maps to a .npz weight bundle (converted once
from the reference artifacts by tools/extract_weights.py) that is loaded into
JAX param pytrees.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

# Valid model names and their configurations (reference: fad.py:109-117).
VALID_MODELS = {
    "vggish": {"sample_rate": 16000, "embedding_dim": 128},
    "pann-8k": {"sample_rate": 8000, "embedding_dim": 2048},
    "pann-16k": {"sample_rate": 16000, "embedding_dim": 2048},
    "pann-32k": {"sample_rate": 32000, "embedding_dim": 2048},
    "encodec-24k": {"sample_rate": 24000, "embedding_dim": 128, "channels": 1},
    "encodec-48k": {"sample_rate": 48000, "embedding_dim": 128, "channels": 2},
    "clap": {"sample_rate": 48000, "embedding_dim": 512},
}

# Map PANN model names to their sample rates (reference: fad.py:120-124).
PANN_SAMPLE_RATES = {
    "pann-8k": 8000,
    "pann-16k": 16000,
    "pann-32k": 32000,
}

# Map Encodec model names to their sample rates (reference: fad.py:127-130).
ENCODEC_SAMPLE_RATES = {
    "encodec-24k": 24000,
    "encodec-48k": 48000,
}

# Weight bundle file names (npz pytrees produced by tools/extract_weights.py).
WEIGHT_FILENAMES = {
    "vggish": "vggish_tpu.npz",
    "pann-8k": "pann_cnn14_8k_tpu.npz",
    "pann-16k": "pann_cnn14_16k_tpu.npz",
    "pann-32k": "pann_cnn14_32k_tpu.npz",
    "encodec-24k": "encodec_24k_tpu.npz",
    "encodec-48k": "encodec_48k_tpu.npz",
    "clap": "clap_tpu.npz",
}

# GitHub release URLs of the reference torch artifacts (reference:
# fad.py:95-106, EXPORTED_MODEL_URLS). On a weight-bundle cache miss, the
# artifact is downloaded here and converted in-process to .npz
# (requires torch for the one-time conversion).
EXPORTED_MODEL_URLS = {
    "vggish": "https://github.com/gibiansky/frechet-audio-distance-exported/releases/download/v0.1/vggish_exported.pt2",
    "pann-8k": "https://github.com/gibiansky/frechet-audio-distance-exported/releases/download/v0.2/pann_cnn14_8k_exported.pt2",
    "pann-16k": "https://github.com/gibiansky/frechet-audio-distance-exported/releases/download/v0.2/pann_cnn14_16k_exported.pt2",
    "pann-32k": "https://github.com/gibiansky/frechet-audio-distance-exported/releases/download/v0.2/pann_cnn14_32k_exported.pt2",
    "encodec-24k": "https://github.com/gibiansky/frechet-audio-distance-exported/releases/download/v0.3/encodec_24k_exported.pt",
    "encodec-48k": "https://github.com/gibiansky/frechet-audio-distance-exported/releases/download/v0.3/encodec_48k_exported.pt",
    "clap": "https://github.com/gibiansky/frechet-audio-distance-exported/releases/download/v0.3/clap_exported.pt2",
}

# Optional sha256 pins for downloaded artifacts, verified when set (the
# reference does no integrity checking; empty entries skip verification).
EXPORTED_MODEL_SHA256: dict = {}

# Direct URLs for pre-converted .npz weight bundles (torch-free install
# path). Checked before EXPORTED_MODEL_URLS; none hosted yet — populate
# when bundles are published, or point at a private mirror via code.
WEIGHT_BUNDLE_URLS: dict = {}

# Optional sha256 pins for the bundles above, verified when set (same
# semantics as EXPORTED_MODEL_SHA256).
WEIGHT_BUNDLE_SHA256: dict = {}

# The reference torch artifacts these weight bundles are converted from
# (reference: fad.py:95-106, fad.py:252-270). tools/extract_weights.py
# consumes these when present in ckpt_dir.
REFERENCE_ARTIFACTS = {
    "vggish": "vggish_exported.pt2",
    "pann-8k": "pann_cnn14_8k_exported.pt2",
    "pann-16k": "pann_cnn14_16k_exported.pt2",
    "pann-32k": "pann_cnn14_32k_exported.pt2",
    "encodec-24k": "encodec_24k_exported.pt",
    "encodec-48k": "encodec_48k_exported.pt",
    "clap": "clap_exported.pt2",
}


def default_ckpt_dir() -> str:
    """Default cache directory for weight bundles.

    The reference uses the torch.hub dir (reference: fad.py:239-244); this
    framework is torch-free at runtime so we use an XDG-style cache dir that
    can be overridden with FAD_TPU_CKPT_DIR.
    """
    env = os.environ.get("FAD_TPU_CKPT_DIR")
    if env:
        return env
    cache_home = os.environ.get("XDG_CACHE_HOME", os.path.join(os.path.expanduser("~"), ".cache"))
    return os.path.join(cache_home, "fad_tpu")


@dataclass(frozen=True)
class ModelConfig:
    """Resolved configuration for one model variant."""

    name: str
    sample_rate: int
    embedding_dim: int
    channels: int = 1
    weight_filename: str = ""
    reference_artifact: str = ""

    @property
    def family(self) -> str:
        if self.name.startswith("pann-"):
            return "pann"
        if self.name.startswith("encodec-"):
            return "encodec"
        return self.name


def get_model_config(model_name: str) -> ModelConfig:
    if model_name not in VALID_MODELS:
        raise ValueError(
            f"Unknown model: {model_name}. Valid options: {list(VALID_MODELS.keys())}"
        )
    cfg = VALID_MODELS[model_name]
    return ModelConfig(
        name=model_name,
        sample_rate=cfg["sample_rate"],
        embedding_dim=cfg["embedding_dim"],
        channels=cfg.get("channels", 1),
        weight_filename=WEIGHT_FILENAMES[model_name],
        reference_artifact=REFERENCE_ARTIFACTS[model_name],
    )
