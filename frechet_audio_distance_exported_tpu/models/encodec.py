"""Encodec SEANet encoder (JAX re-implementation).

The reference ships Meta's Encodec encoder only as an opaque TorchScript trace
(reference: fad.py:292-295, scripts/export_encodec.py:231-277; architecture
facts at scripts/export_encodec.py:146-168 and README.md:361). This module
re-implements the SEANetEncoder itself:

- input conv k=7 (channels -> 32)
- 4 stages, downsample ratios [2, 4, 5, 8] (total hop 320): each stage is a
  residual block (ELU -> conv k=3 dim->dim/2 -> ELU -> conv k=1 dim/2->dim,
  plus a k=1 shortcut conv) followed by ELU and a strided conv k=2r, s=r that
  doubles the width (32 -> 64 -> 128 -> 256 -> 512)
- 2-layer LSTM(512) with residual skip (lax.scan; layer 0's input
  projection is hoisted out of the scan as one big matmul)
- ELU -> output conv k=7 (512 -> 128)

Variant differences (Meta encodec 0.1.x):
- 24 kHz: mono, causal=True, weight_norm (folded into the extracted weights)
- 48 kHz: stereo, causal=False, GroupNorm(1, C) ('time_group_norm') after
  every conv

Padding replicates encodec's math.ceil-based asymmetric reflect padding
statically (the reference had to torch.jit.trace because torch.export chokes
on it, scripts/export_encodec.py:231-239; with static shapes it is just
Python arithmetic at trace time).

Input:  [B, C, S] float32 waveform, S fixed at 10 s (240k/480k samples)
Output: [B, S//320, 128] per-frame embeddings
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp

from . import common
from .. import config

EMBEDDING_SIZE = 128
N_FILTERS = 32
DIMENSION = 128
RATIOS = (2, 4, 5, 8)  # encoder order (reversed [8,5,4,2] of the decoder spec)
LSTM_LAYERS = 2


# ---------------------------------------------------------------------------
# Conv with encodec's asymmetric reflect padding (static shapes)
# ---------------------------------------------------------------------------


def _pad_amounts(length: int, kernel: int, stride: int, causal: bool):
    padding_total = kernel - stride
    n_frames = (length - kernel + padding_total) / stride + 1
    ideal_length = (math.ceil(n_frames) - 1) * stride + (kernel - padding_total)
    extra = ideal_length - length
    if causal:
        return padding_total, extra
    right = padding_total // 2
    return padding_total - right, right + extra


def _sconv(p: dict, x: jnp.ndarray, kernel: int, stride: int, causal: bool) -> jnp.ndarray:
    """x: [B, T, C] -> conv (+ optional GroupNorm(1, C)) with reflect padding."""
    left, right = _pad_amounts(x.shape[1], kernel, stride, causal)
    if left or right:
        x = jnp.pad(x, ((0, 0), (left, right), (0, 0)), mode="reflect")
    y = common.conv1d(x, p["w"], p["b"], stride=stride)
    if "gn" in p:
        y = common.group_norm_full(y, p["gn"]["gamma"], p["gn"]["beta"])
    return y


def _res_block(p: dict, x: jnp.ndarray, causal: bool) -> jnp.ndarray:
    h = jax.nn.elu(x)
    h = _sconv(p["conv1"], h, kernel=3, stride=1, causal=causal)
    h = jax.nn.elu(h)
    h = _sconv(p["conv2"], h, kernel=1, stride=1, causal=causal)
    return _sconv(p["shortcut"], x, kernel=1, stride=1, causal=causal) + h


# ---------------------------------------------------------------------------
# LSTM (2 layers, residual skip) via lax.scan
# ---------------------------------------------------------------------------


def _lstm_cell(gates: jnp.ndarray, c_prev: jnp.ndarray):
    """torch gate order i, f, g, o."""
    i, f, g, o = jnp.split(gates, 4, axis=-1)
    c = jax.nn.sigmoid(f) * c_prev + jax.nn.sigmoid(i) * jnp.tanh(g)
    return jax.nn.sigmoid(o) * jnp.tanh(c), c


def _slstm(
    p: dict, x: jnp.ndarray, unroll: int = 0, op_dtype=jnp.float32
) -> jnp.ndarray:
    """2-layer LSTM with the SEANet residual skip (y = lstm(x) + x).

    Structure:
    - layer 0's input projection is hoisted out of the scan as one big
      [B*T, H] x [H, 4H] matmul;
    - both layers run in ONE wavefront scan — layer 1's step t consumes
      layer 0's output at t inside the same iteration, so the scan has T
      iterations instead of 2T (identical math, same op order per layer);
    - layer 1's input and recurrent projections fuse into a single
      [B, 2H] x [2H, 4H] matmul;
    - the scan is unrolled so XLA can schedule consecutive iterations
      together.

    The carried h/c state, gate nonlinearities, and accumulation always run
    in float32 regardless of the caller's compute dtype: a fully-bf16
    recurrence compounds error over the ~750 sequential steps and destroys
    the score (FAD 918 vs 3e-4 on identical dirs). In mixed-precision mode
    the conv stages run bf16 and hand off f32 here.

    ``op_dtype`` sets ONLY the in-scan recurrent-matmul operand dtype
    (config.lstm_op_dtype: float32 unless FAD_TPU_LSTM_MATMUL=bfloat16).
    """
    x = x.astype(jnp.float32)
    b, t, h = x.shape
    if not unroll:
        # Prefer an unroll that DIVIDES the step count (no remainder loop;
        # 30 divides both the 24k T=750 and the 48k T=1500). Step counts with
        # no divisor >= 8 (e.g. prime T) take 20 with a remainder loop, since
        # a tiny unroll gives XLA nothing to schedule across iterations.
        unroll = next(
            (u for u in (32, 30, 25, 20, 16, 15, 12, 10, 8) if t % u == 0), 20
        )
    p0, p1 = p["l0"], p["l1"]
    gates_x0 = common.linear(x.reshape(b * t, h), p0["w_ih"], p0["b_ih"]).reshape(b, t, 4 * h)
    gates_x0 = jnp.swapaxes(gates_x0, 0, 1)  # [T, B, 4H] time-major for scan
    w1 = jnp.concatenate([p1["w_ih"], p1["w_hh"]], axis=0)  # [2H, 4H]
    b1 = p1["b_ih"] + p1["b_hh"]

    if op_dtype == jnp.bfloat16:
        w0hh_c, w1_c = p0["w_hh"].astype(op_dtype), w1.astype(op_dtype)

        def proj0(h0):
            return jnp.matmul(
                h0.astype(op_dtype), w0hh_c, preferred_element_type=jnp.float32
            ) + p0["b_hh"]

        def proj1(y0h1):
            return jnp.matmul(
                y0h1.astype(op_dtype), w1_c, preferred_element_type=jnp.float32
            ) + b1

    else:

        def proj0(h0):
            return common.linear(h0, p0["w_hh"], p0["b_hh"])

        def proj1(y0h1):
            return common.linear(y0h1, w1, b1)

    def step(carry, gx0):
        h0, c0, h1, c1 = carry
        y0, c0 = _lstm_cell(gx0 + proj0(h0), c0)
        y1, c1 = _lstm_cell(proj1(jnp.concatenate([y0, h1], axis=-1)), c1)
        return (y0, c0, y1, c1), y1

    zeros = jnp.zeros((b, h), x.dtype)
    _, ys = jax.lax.scan(step, (zeros, zeros, zeros, zeros), gates_x0, unroll=unroll)
    return jnp.swapaxes(ys, 0, 1) + x


# ---------------------------------------------------------------------------
# Encoder forward
# ---------------------------------------------------------------------------


def encodec_forward(params: dict, x: jnp.ndarray, causal: bool = True) -> jnp.ndarray:
    """[B, C, S] waveform (float32, or PCM16-exact int16) -> [B, S//320, 128]
    frame embeddings.

    The env knobs (FAD_TPU_LSTM_MATMUL / FAD_TPU_PRECISION /
    FAD_TPU_MODEL_DTYPE) are resolved HERE, at call time, and folded into
    the jit key as statics — flipping them mid-process retraces instead of
    silently reusing a stale traced branch (same contract as the frontend
    wrappers, advisor r4 / code-review r5). Called inside an outer jit
    (e.g. the pipeline core), resolution happens at that trace's build
    time, as before.
    """
    return _encodec_forward_jit(
        params, x, causal, config.lstm_op_dtype(), config.matmul_precision()
    )


@functools.partial(
    jax.jit, static_argnames=("causal", "lstm_op_dtype", "precision")
)
def _encodec_forward_jit(
    params: dict, x: jnp.ndarray, causal: bool, lstm_op_dtype, precision
) -> jnp.ndarray:
    # `precision` is consumed inside common.conv1d via config.matmul_precision()
    # at trace time; it sits in the jit key only so an env flip forces the
    # retrace that re-reads it.
    del precision
    if x.dtype == jnp.int16:
        x = x.astype(jnp.float32) / 32768.0
    # Mixed-precision entry: the conv stages run in the weights' dtype (bf16
    # in FAD_TPU_MODEL_DTYPE=bfloat16 mode); _slstm and conv_out re-enter
    # float32 (their params are never downcast).
    x = x.astype(params["conv_in"]["w"].dtype)
    h = jnp.swapaxes(x, 1, 2)  # NWC
    h = _sconv(params["conv_in"], h, kernel=7, stride=1, causal=causal)
    for ratio, stage in zip(RATIOS, params["stages"]):
        # Stage boundary: follow the stage's weight dtype (no-op in
        # uniform modes; enables per-stage precision mixes without
        # f32<->bf16 ping-pong inside a stage).
        h = h.astype(stage["res"]["conv1"]["w"].dtype)
        h = _res_block(stage["res"], h, causal)
        h = jax.nn.elu(h)
        h = _sconv(stage["down"], h, kernel=2 * ratio, stride=ratio, causal=causal)
    h = _slstm(params["lstm"], h, op_dtype=lstm_op_dtype)
    h = jax.nn.elu(h)
    h = _sconv(params["conv_out"], h, kernel=7, stride=1, causal=causal)
    return h  # [B, T, 128]


# ---------------------------------------------------------------------------
# Init (random weights for tests/benches; real weights via tools/)
# ---------------------------------------------------------------------------


def _init_sconv(rng, k, cin, cout, group_norm: bool):
    p = common.init_conv1d(rng, k, cin, cout)
    if group_norm:
        p["gn"] = common.init_layer_norm(cout)
    return p


def init_encodec_params(rng: jax.Array, causal: bool = True, channels: int = 1) -> dict:
    """causal=True mirrors the 24 kHz variant (weight_norm folded, no GN);
    causal=False mirrors 48 kHz (GroupNorm after every conv)."""
    gn = not causal
    keys = iter(jax.random.split(rng, 32))
    params = {"conv_in": _init_sconv(next(keys), 7, channels, N_FILTERS, gn), "stages": []}
    mult = 1
    for ratio in RATIOS:
        dim = N_FILTERS * mult
        params["stages"].append(
            {
                "res": {
                    "conv1": _init_sconv(next(keys), 3, dim, dim // 2, gn),
                    "conv2": _init_sconv(next(keys), 1, dim // 2, dim, gn),
                    "shortcut": _init_sconv(next(keys), 1, dim, dim, gn),
                },
                "down": _init_sconv(next(keys), 2 * ratio, dim, 2 * dim, gn),
            }
        )
        mult *= 2
    hidden = N_FILTERS * mult  # 512
    bound = float(1.0 / math.sqrt(hidden))
    lstm = {}
    for layer in ("l0", "l1"):
        k1, k2, k3, k4 = jax.random.split(next(keys), 4)
        lstm[layer] = {
            "w_ih": jax.random.uniform(k1, (hidden, 4 * hidden), jnp.float32, -bound, bound),
            "w_hh": jax.random.uniform(k2, (hidden, 4 * hidden), jnp.float32, -bound, bound),
            "b_ih": jax.random.uniform(k3, (4 * hidden,), jnp.float32, -bound, bound),
            "b_hh": jax.random.uniform(k4, (4 * hidden,), jnp.float32, -bound, bound),
        }
    params["lstm"] = lstm
    params["conv_out"] = _init_sconv(next(keys), 7, hidden, DIMENSION, gn)
    return params
