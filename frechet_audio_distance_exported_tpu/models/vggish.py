"""VGGish embedding network (JAX re-implementation).

Architecture spec from the reference VGGishCore (reference:
models/vggish.py:40-95): VGG conv stack [64, M, 128, M, 256, 256, M, 512,
512, M] of 3x3/SAME convs + ReLU and 2x2 max pools, then a channel-last
flatten (the reference transposes NCHW->NHWC before flattening for
TF-VGGish weight compatibility — NHWC here flattens natively in the same
order), then FC 512*6*4 -> 4096 -> ReLU -> 4096 -> ReLU -> 128 with **no**
final ReLU (use_activation=False semantics).

Input:  [B, 96, 64] log-mel patches (frontends.vggish_patches_batch)
Output: [B, 128] embeddings
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from . import common
from ..config import matmul_precision

EMBEDDING_SIZE = 128
NUM_FRAMES = 96
NUM_BANDS = 64

# Conv channel plan; 'M' is a 2x2/2 max pool (reference: models/vggish.py:44).
CONV_CFG = (64, "M", 128, "M", 256, 256, "M", 512, 512, "M")


def init_vggish_params(rng: jax.Array) -> dict:
    """Randomly initialized params (torch-default-like); real weights come
    from tools/extract_weights.py via utils.weights."""
    params = {"features": [], "embeddings": []}
    cin = 1
    for v in CONV_CFG:
        if v == "M":
            continue
        rng, sub = jax.random.split(rng)
        params["features"].append(common.init_conv2d(sub, 3, 3, cin, int(v)))
        cin = int(v)
    dims = [(512 * 6 * 4, 4096), (4096, 4096), (4096, EMBEDDING_SIZE)]
    for din, dout in dims:
        rng, sub = jax.random.split(rng)
        params["embeddings"].append(common.init_linear(sub, din, dout))
    return params


def vggish_forward(params: dict, x: jnp.ndarray) -> jnp.ndarray:
    """[B, 96, 64] log-mel patches -> [B, 128] embeddings.

    FAD_TPU_PRECISION resolves at call time and sits in the jit key, so a
    mid-process flip retraces instead of reusing the stale branch (the
    frontend/encodec wrappers' contract; code-review r5)."""
    return _vggish_forward_jit(params, x, matmul_precision())


@functools.partial(jax.jit, static_argnames=("precision",))
def _vggish_forward_jit(params: dict, x: jnp.ndarray, precision) -> jnp.ndarray:
    # `precision` is consumed inside common.conv2d/linear via
    # config.matmul_precision() at trace time; it sits in the jit key only
    # so an env flip forces the retrace that re-reads it.
    del precision
    # Trace-time guard: a transposed [B, 64, 96] input pools to the same
    # flattened 12288 features and returns numerically valid garbage, so the
    # mistake must fail loudly here rather than corrupt scores silently.
    # (ValueError, not assert: python -O must not strip the guard.)
    if x.shape[-2:] != (NUM_FRAMES, NUM_BANDS):
        raise ValueError(f"expected [..., 96, 64] patches, got {x.shape}")
    h = x[..., None]  # NHWC
    conv_i = 0
    for v in CONV_CFG:
        if v == "M":
            h = common.max_pool2d(h, (2, 2), (2, 2))
        else:
            p = params["features"][conv_i]
            h = jax.nn.relu(common.conv2d(h, p["w"], p["b"]))
            conv_i += 1
    # [B, 6, 4, 512]: NHWC flatten == the reference's transpose-then-flatten
    # (reference: models/vggish.py:91-94).
    h = h.reshape(h.shape[0], -1)
    h = jax.nn.relu(common.linear(h, **params["embeddings"][0]))
    h = jax.nn.relu(common.linear(h, **params["embeddings"][1]))
    return common.linear(h, **params["embeddings"][2])
