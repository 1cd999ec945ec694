"""Numerics and platform policy.

The reference computes everything in float32 (torch CPU) or float64 (NumPy
frontends). This module is the one place that decides how this program
computes; the rules are the same on the GPU and on the CPU the tests run on:

- Model compute is float32 (``model_dtype``); FAD_TPU_MODEL_DTYPE=bfloat16
  opts into bfloat16 explicitly (EnCodec then runs mixed precision,
  pipeline.cast_model_params).
- EnCodec's in-scan recurrent matmuls take float32 operands
  (``lstm_op_dtype``); FAD_TPU_LSTM_MATMUL=bfloat16 opts in.
- Files per device program default to ``DEFAULT_FILE_BATCH`` (not yet swept
  on the GPU).

Matmul/conv precision of float32 operands is set by FAD_TPU_PRECISION:

- 'high' (default): XLA:GPU may run float32 products on the tensor cores as
  TF32 (operands rounded to a 10-bit mantissa, float32 accumulation).
- 'highest': full float32 products, the closest to the reference.
- 'default'/'bfloat16': the backend's fastest float32 product (TF32 on
  XLA:GPU, like 'high').

The CPU backend computes full float32 products under every setting.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

_PRECISIONS = {
    "highest": jax.lax.Precision.HIGHEST,
    "high": jax.lax.Precision.HIGH,
    "default": jax.lax.Precision.DEFAULT,
    "bfloat16": jax.lax.Precision.DEFAULT,
}

# Files per device program when the caller passes no file_batch. These are
# the batches the GPU path has run with since it first ran; no sweep on the
# card has set them yet. EnCodec's 10 s waveforms make the widest
# activations, so it takes half.
DEFAULT_FILE_BATCH = {"vggish": 32, "pann": 32, "clap": 32, "encodec": 16}

# Persistent compile cache used when JAX_COMPILATION_CACHE_DIR is unset: a
# fixed directory of the checkout (listed in .gitignore). A fixed path keeps
# the cache's keys stable from one process to the next.
COMPILE_CACHE_DIR = Path(__file__).resolve().parent.parent / ".jax_compile_cache"


def matmul_precision() -> jax.lax.Precision:
    name = os.environ.get("FAD_TPU_PRECISION", "high").strip().lower()
    try:
        return _PRECISIONS[name]
    except KeyError:
        # A typo must not surface as a bare KeyError from inside jit tracing.
        raise ValueError(
            f"FAD_TPU_PRECISION={name!r}: expected one of {sorted(_PRECISIONS)}"
        ) from None


def compilation_cache_dir() -> str | None:
    """Directory this program points JAX's persistent compile cache at, or
    None when JAX_COMPILATION_CACHE_DIR is set (JAX reads that variable
    itself and the program sets nothing)."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return str(COMPILE_CACHE_DIR)


def enable_compilation_cache() -> None:
    """Persist compiled programs across processes. Called lazily from
    FrechetAudioDistance.__init__ (not at import time: a library must not
    mutate global jax.config as an import side effect). JAX's own
    ``jax_enable_compilation_cache`` option still turns the cache off."""
    path = compilation_cache_dir()
    if path is not None:
        jax.config.update("jax_compilation_cache_dir", path)


def exactness_forced() -> bool:
    """True when the user explicitly asked for the bitwise-closest numerics:
    FAD_TPU_PRECISION=highest, or an explicit FAD_TPU_MODEL_DTYPE=float32.

    VGGish's device frontend then keeps the chunk-sum DFT accumulation order
    instead of its single lane-concatenated matmul (ops/frontends.py)."""
    import jax.numpy as jnp

    if os.environ.get("FAD_TPU_PRECISION", "").strip().lower() == "highest":
        return True
    return bool(os.environ.get("FAD_TPU_MODEL_DTYPE")) and model_dtype() == jnp.float32


def exact_sqrtm() -> bool:
    """FAD_TPU_EXACT_SQRTM=1 selects the reference's scipy sqrtm algorithm
    bit-for-bit over the exact-but-faster Gram/eigh epilogues."""
    return os.environ.get("FAD_TPU_EXACT_SQRTM", "") not in ("", "0")


def _dtype_from_env(var: str):
    """float32 unless ``var`` names bfloat16; a typo raises instead of
    silently falling back to the default."""
    import jax.numpy as jnp

    name = os.environ.get(var, "").strip().lower()
    if name in ("bfloat16", "bf16"):
        return jnp.bfloat16
    if name in ("", "float32", "f32", "fp32"):
        return jnp.float32
    raise ValueError(f"{var}={name!r}: expected 'float32' or 'bfloat16'")


def model_dtype():
    """Model compute dtype: float32, or bfloat16 under
    FAD_TPU_MODEL_DTYPE=bfloat16.

    In bfloat16 mode EnCodec runs MIXED precision (conv stages bf16, LSTM and
    output projection float32, pipeline.cast_model_params): full bf16
    compounds error over the LSTM's ~750 sequential steps and destroys the
    score. Statistics and frontends always stay float32."""
    return _dtype_from_env("FAD_TPU_MODEL_DTYPE")


def lstm_op_dtype():
    """Operand dtype for EnCodec's in-scan recurrent matmuls: float32, or
    bfloat16 under FAD_TPU_LSTM_MATMUL=bfloat16. The carry, gates and
    accumulation always stay float32 (models/encodec._slstm)."""
    return _dtype_from_env("FAD_TPU_LSTM_MATMUL")
