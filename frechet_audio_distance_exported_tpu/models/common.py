"""Functional NN building blocks shared by all model families.

Pure-pytree design: params are nested dicts of jnp arrays, forwards are pure
functions — trivially jittable, shardable with shard_map, and loadable from
.npz weight bundles without any framework coupling.

Conventions:
- Activations are NHWC, conv kernels HWIO (XLA's preferred layouts; the reference's
  torch NCHW/OIHW weights are transposed once at extraction time by
  tools/extract_weights.py).
- Linear weights are [in, out].
- BatchNorm is inference-only (folded to scale/shift at call time); the
  reference models are inference-only too.
"""

from __future__ import annotations

import math

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import matmul_precision


def conv2d(
    x: jnp.ndarray,
    w: jnp.ndarray,
    b: Optional[jnp.ndarray] = None,
    stride: Tuple[int, int] = (1, 1),
    padding="SAME",
) -> jnp.ndarray:
    """NHWC conv with HWIO kernel."""
    out = jax.lax.conv_general_dilated(
        x, w, window_strides=stride, padding=padding,
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.float32,  # f32 accumulation even in bf16 mode
        precision=matmul_precision(),
    ).astype(x.dtype)
    if b is not None:
        out = out + b
    return out


def conv1d(
    x: jnp.ndarray,
    w: jnp.ndarray,
    b: Optional[jnp.ndarray] = None,
    stride: int = 1,
    dilation: int = 1,
) -> jnp.ndarray:
    """NWC conv with WIO kernel, VALID padding (callers pad explicitly —
    Encodec's asymmetric reflect pads are applied outside)."""
    out = jax.lax.conv_general_dilated(
        x, w, window_strides=(stride,), padding="VALID",
        rhs_dilation=(dilation,),
        dimension_numbers=("NWC", "WIO", "NWC"),
        preferred_element_type=jnp.float32,  # f32 accumulation even in bf16 mode
        precision=matmul_precision(),
    ).astype(x.dtype)
    if b is not None:
        out = out + b
    return out


def max_pool2d(x: jnp.ndarray, window: Tuple[int, int], stride: Tuple[int, int]) -> jnp.ndarray:
    """NHWC max pool, VALID padding (floor semantics, matching torch)."""
    return jax.lax.reduce_window(
        x, -jnp.inf, jax.lax.max,
        window_dimensions=(1,) + window + (1,),
        window_strides=(1,) + stride + (1,),
        padding="VALID",
    )


def avg_pool2d(x: jnp.ndarray, window: Tuple[int, int], stride: Tuple[int, int]) -> jnp.ndarray:
    """NHWC average pool, VALID padding (floor semantics, matching torch)."""
    summed = jax.lax.reduce_window(
        x, 0.0, jax.lax.add,
        window_dimensions=(1,) + window + (1,),
        window_strides=(1,) + stride + (1,),
        padding="VALID",
    )
    return summed / float(window[0] * window[1])


def batch_norm(x: jnp.ndarray, p: dict, eps: float = 1e-5) -> jnp.ndarray:
    """Inference batch norm along the trailing (channel) axis.

    p: {'gamma','beta','mean','var'} 1-D arrays of the channel size.
    """
    scale = p["gamma"] * jax.lax.rsqrt(p["var"] + eps)
    shift = p["beta"] - p["mean"] * scale
    return x * scale + shift


def group_norm_full(x: jnp.ndarray, gamma: jnp.ndarray, beta: jnp.ndarray, eps: float = 1e-5) -> jnp.ndarray:
    """GroupNorm with a single group over [B, ..., C]: normalize each example
    over every non-batch axis, then apply per-channel affine (trailing axis).

    Matches torch nn.GroupNorm(1, C) as used by Encodec's time_group_norm.
    The reduction spans every non-batch element (B x T x C can be ~10^7), so
    it always runs in float32 — a bfloat16 accumulation there would lose the
    mean entirely; the result re-enters x.dtype.

    The moments are computed as (Σx, Σx²) in ONE pass: the two sums have no
    sequential dependency, so XLA multi-output-fuses them into a single read
    of x, vs the textbook mean-then-centered-variance which reads x twice.
    This is encodec-48k's hot path (GN follows every conv there, over the
    [16, 480k, C] stage-1/2 tensors). E[x²]−E[x]² cancellation error is
    ~ε·mean²/var relative; for
    these post-conv activations mean²/var is O(1)-O(10²), i.e. ≤1e-5 in f32
    — far inside the 1e-3 FAD parity bar (empirically <2e-6 on the full
    model vs the two-pass form).
    """
    xf = x.astype(jnp.float32)
    axes = tuple(range(1, x.ndim))
    n = math.prod(x.shape[1:])
    s = jnp.sum(xf, axis=axes, keepdims=True)
    ss = jnp.sum(xf * xf, axis=axes, keepdims=True)
    mean = s / n
    var = jnp.maximum(ss / n - mean * mean, 0.0)
    out = (xf - mean) * jax.lax.rsqrt(var + eps) * gamma.astype(jnp.float32) + beta.astype(
        jnp.float32
    )
    return out.astype(x.dtype)


def layer_norm(x: jnp.ndarray, gamma: jnp.ndarray, beta: jnp.ndarray, eps: float = 1e-5) -> jnp.ndarray:
    """LayerNorm over the trailing axis. The moment reduction runs in float32
    (a bf16 mean/variance loses ~2 digits); the result re-enters x.dtype.

    Moments as (Σx, Σx²) in one fused pass, like group_norm_full — here the
    per-row reduction is only C<=768 wide so cancellation error is tiny
    (verified <1e-5 on CLAP's full forward vs the two-pass form)."""
    xf = x.astype(jnp.float32)
    n = x.shape[-1]
    s = jnp.sum(xf, axis=-1, keepdims=True)
    ss = jnp.sum(xf * xf, axis=-1, keepdims=True)
    mean = s / n
    var = jnp.maximum(ss / n - mean * mean, 0.0)
    out = (xf - mean) * jax.lax.rsqrt(var + eps) * gamma.astype(jnp.float32) + beta.astype(
        jnp.float32
    )
    return out.astype(x.dtype)


def linear(x: jnp.ndarray, w: jnp.ndarray, b: Optional[jnp.ndarray] = None) -> jnp.ndarray:
    out = jnp.matmul(
        x, w, preferred_element_type=jnp.float32, precision=matmul_precision()
    ).astype(x.dtype)
    if b is not None:
        out = out + b
    return out


# ---------------------------------------------------------------------------
# Initializers (torch-default-like; used for random-weight tests/benches)
# ---------------------------------------------------------------------------


def init_conv2d(rng, kh, kw, cin, cout, bias=True):
    k1, k2 = jax.random.split(rng)
    fan_in = kh * kw * cin
    bound = float(np.sqrt(1.0 / fan_in))
    p = {"w": jax.random.uniform(k1, (kh, kw, cin, cout), jnp.float32, -bound, bound)}
    if bias:
        p["b"] = jax.random.uniform(k2, (cout,), jnp.float32, -bound, bound)
    return p


def init_conv1d(rng, k, cin, cout, bias=True):
    k1, k2 = jax.random.split(rng)
    fan_in = k * cin
    bound = float(np.sqrt(1.0 / fan_in))
    p = {"w": jax.random.uniform(k1, (k, cin, cout), jnp.float32, -bound, bound)}
    if bias:
        p["b"] = jax.random.uniform(k2, (cout,), jnp.float32, -bound, bound)
    return p


def init_linear(rng, cin, cout, bias=True):
    k1, k2 = jax.random.split(rng)
    bound = float(np.sqrt(1.0 / cin))
    p = {"w": jax.random.uniform(k1, (cin, cout), jnp.float32, -bound, bound)}
    if bias:
        p["b"] = jax.random.uniform(k2, (cout,), jnp.float32, -bound, bound)
    return p


def init_batch_norm(dim):
    return {
        "gamma": jnp.ones((dim,), jnp.float32),
        "beta": jnp.zeros((dim,), jnp.float32),
        "mean": jnp.zeros((dim,), jnp.float32),
        "var": jnp.ones((dim,), jnp.float32),
    }


def init_layer_norm(dim):
    return {"gamma": jnp.ones((dim,), jnp.float32), "beta": jnp.zeros((dim,), jnp.float32)}
