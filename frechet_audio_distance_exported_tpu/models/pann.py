"""PANN CNN14 embedding network (JAX re-implementation).

Architecture spec from the reference PANNCore (reference:
models/pann.py:152-273): bn0 BatchNorm over the 64 mel bins (applied via a
transpose sandwich in torch; here it is a plain per-mel-bin affine), six
ConvBlocks (two 3x3/SAME bias-free convs + BN + ReLU, then 2x2 average pool;
block 6 pools 1x1), mean over the frequency axis, (max over time + mean over
time), and fc1 Linear(2048, 2048) + ReLU.

The same weights serve all three sample-rate variants; only the frontend
differs (reference: models/pann.py:206-210).

Input:  [B, T, 64] log-mel (T on the 32k-24 grid, zero rows included — they
        are part of the reference numerics, see frontends.pann_valid_time)
Output: [B, 2048] embeddings
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from . import common
from ..config import matmul_precision

EMBEDDING_SIZE = 2048
MEL_BINS = 64

# (in_channels, out_channels) per ConvBlock (reference: models/pann.py:226-231)
BLOCK_CHANNELS = ((1, 64), (64, 128), (128, 256), (256, 512), (512, 1024), (1024, 2048))


def init_pann_params(rng: jax.Array) -> dict:
    params = {"bn0": common.init_batch_norm(MEL_BINS), "blocks": []}
    for cin, cout in BLOCK_CHANNELS:
        rng, k1, k2 = jax.random.split(rng, 3)
        params["blocks"].append(
            {
                "conv1": common.init_conv2d(k1, 3, 3, cin, cout, bias=False),
                "bn1": common.init_batch_norm(cout),
                "conv2": common.init_conv2d(k2, 3, 3, cout, cout, bias=False),
                "bn2": common.init_batch_norm(cout),
            }
        )
    rng, sub = jax.random.split(rng)
    params["fc1"] = common.init_linear(sub, EMBEDDING_SIZE, EMBEDDING_SIZE)
    return params


def _conv_block(p: dict, x: jnp.ndarray, pool: int) -> jnp.ndarray:
    x = jax.nn.relu(common.batch_norm(common.conv2d(x, p["conv1"]["w"]), p["bn1"]))
    x = jax.nn.relu(common.batch_norm(common.conv2d(x, p["conv2"]["w"]), p["bn2"]))
    if pool > 1:
        x = common.avg_pool2d(x, (pool, pool), (pool, pool))
    return x


def pann_forward(params: dict, x: jnp.ndarray) -> jnp.ndarray:
    """[B, T, 64] log-mel -> [B, 2048] embeddings.

    FAD_TPU_PRECISION resolves at call time and sits in the jit key, so a
    mid-process flip retraces instead of reusing the stale branch (the
    frontend/encodec wrappers' contract; code-review r5)."""
    return _pann_forward_jit(params, x, matmul_precision())


@functools.partial(jax.jit, static_argnames=("precision",))
def _pann_forward_jit(params: dict, x: jnp.ndarray, precision) -> jnp.ndarray:
    # In the jit key only (re-read inside common.conv2d at retrace time).
    del precision
    # bn0 across mel bins (the reference's transpose(1,3) sandwich,
    # reference: models/pann.py:249-251, collapses to a per-bin affine).
    h = common.batch_norm(x, params["bn0"])
    h = h[..., None]  # [B, T, 64, 1] NHWC
    for i, blk in enumerate(params["blocks"]):
        h = _conv_block(blk, h, pool=1 if i == 5 else 2)
    # [B, T/32, 2, 2048]: mean over frequency, then max+mean over time
    # (reference: models/pann.py:263-268). The pooling tail runs in float32
    # even in bf16 mode: the time mean accumulates over up to ~8k pooled
    # frames for long files, where a bf16 accumulation would drift past the
    # parity bar (same policy as the norm reductions in models/common.py and
    # CLAP's pooling tail); the tensors here are tiny.
    h = h.astype(jnp.float32)
    h = jnp.mean(h, axis=2)
    h = jnp.max(h, axis=1) + jnp.mean(h, axis=1)
    h = h.astype(x.dtype)
    return jax.nn.relu(common.linear(h, **params["fc1"]))
