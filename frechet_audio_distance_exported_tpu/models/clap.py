"""CLAP audio encoder: HTSAT-tiny Swin transformer + projection head
(JAX re-implementation).

The reference ships this only inside a torch.export artifact; the
architecture facts come from its export wrapper and docstrings
(reference: scripts/export_clap.py:88-150, models/clap.py:3-13):

- bicubic time interpolation of the [B, 1, 1001, 64] log-mel to 1024 frames
  (align_corners=True; reference: export_clap.py:124-128) — implemented here
  as four static gathers + a weighted sum (see _bicubic_taps)
- bn0 BatchNorm over the 64 mel bins (reference: export_clap.py:130-133)
- reshape_wav2img with freq_ratio=4, spec_size=256: the (1024, 64) mel is
  folded into a (256, 256) single-channel image, row = time_quarter*64 +
  mel_bin, col = time_within_quarter (reference: export_clap.py:136-140)
- HTSAT-tiny = Swin: patch_embed 4x4/4 conv -> 96 dims + LayerNorm,
  depths [2, 2, 6, 2], heads [4, 8, 16, 32], window 8, mlp_ratio 4,
  qkv_bias, patch merging between stages, shifted windows on alternate
  blocks (shift disabled in the last stage where resolution == window)
- embedding = mean over all tokens of the final LayerNorm output (HTSAT's
  avgpool over the freq-grouped latent — a global token mean is invariant to
  that regrouping), 768 dims
- projection Linear(768, 512) -> ReLU -> Linear(512, 512), then L2
  normalization (reference: export_clap.py:143-149)

Input:  [B, 1001, 64] log-mel (dB)
Output: [B, 512] L2-normalized embeddings
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from . import common
from ..config import matmul_precision


EMBEDDING_SIZE = 512
SPEC_SIZE = 256
FREQ_RATIO = 4
PATCH_SIZE = 4
EMBED_DIM = 96
DEPTHS = (2, 2, 6, 2)
NUM_HEADS = (4, 8, 16, 32)
WINDOW_SIZE = 8
MLP_RATIO = 4
TARGET_T = SPEC_SIZE * FREQ_RATIO  # 1024
MEL_BINS = 64

_STAGE_DIMS = tuple(EMBED_DIM * (2 ** i) for i in range(4))  # 96,192,384,768
_STAGE_RES = tuple((SPEC_SIZE // PATCH_SIZE) // (2 ** i) for i in range(4))  # 64,32,16,8


# ---------------------------------------------------------------------------
# Host-built constants
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=4)
def _bicubic_time_matrix(in_t: int, out_t: int) -> np.ndarray:
    """[out_t, in_t] bicubic interpolation matrix, align_corners=True,
    torch's A=-0.75 kernel (reference behavior: export_clap.py:126)."""
    a = -0.75

    def cc1(x):  # |x| <= 1
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0

    def cc2(x):  # 1 < |x| < 2
        return ((a * x - 5.0 * a) * x + 8.0 * a) * x - 4.0 * a

    m = np.zeros((out_t, in_t), dtype=np.float64)
    scale = (in_t - 1) / (out_t - 1) if out_t > 1 else 0.0
    for j in range(out_t):
        src = j * scale
        i0 = int(np.floor(src))
        t = src - i0
        w = (cc2(t + 1.0), cc1(t), cc1(1.0 - t), cc2(2.0 - t))
        for k, wk in enumerate(w):
            idx = min(max(i0 - 1 + k, 0), in_t - 1)
            m[j, idx] += wk
    return m.astype(np.float32)


@functools.lru_cache(maxsize=4)
def _bicubic_taps(in_t: int, out_t: int):
    """(idx [out_t, 4] int32, w [out_t, 4] f32): the <=4 nonzero columns of
    each _bicubic_time_matrix row (edge-clamped taps pre-merged, zero-padded).

    The interpolation then runs as four static gathers + an elementwise
    weighted sum instead of a dense [out_t, in_t] matmul: fp-equivalent
    (4.5e-8 embedding delta on CPU f32 — pure fp reordering), while the
    dense form burns 250x the FLOPs and blocks fusion with bn0."""
    m = _bicubic_time_matrix(in_t, out_t)
    idx = np.zeros((out_t, 4), np.int32)
    w = np.zeros((out_t, 4), np.float32)
    for j in range(out_t):
        nz = np.nonzero(m[j])[0]
        idx[j, : len(nz)] = nz
        w[j, : len(nz)] = m[j, nz]
    return idx, w


@functools.lru_cache(maxsize=8)
def _relative_position_index(ws: int) -> np.ndarray:
    """[N, N] index into the (2*ws-1)^2 relative position bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0) + (ws - 1)
    return (rel[..., 0] * (2 * ws - 1) + rel[..., 1]).astype(np.int32)


@functools.lru_cache(maxsize=8)
def _shift_attn_mask(res: int, ws: int, shift: int) -> np.ndarray:
    """[num_windows, N, N] additive mask for shifted-window attention."""
    img = np.zeros((res, res), dtype=np.int32)
    cnt = 0
    slices = (slice(0, -ws), slice(-ws, -shift), slice(-shift, None))
    for hs in slices:
        for wsl in slices:
            img[hs, wsl] = cnt
            cnt += 1
    win = img.reshape(res // ws, ws, res // ws, ws).transpose(0, 2, 1, 3).reshape(-1, ws * ws)
    diff = win[:, None, :] - win[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


# ---------------------------------------------------------------------------
# Swin pieces
# ---------------------------------------------------------------------------


def _gathered_rel_bias(rel_bias: jnp.ndarray, ws: int, heads: int) -> jnp.ndarray:
    """[(2ws-1)^2, heads] table -> [heads, N, N] f32 additive bias."""
    n = ws * ws
    idx = _relative_position_index(ws)
    bias = rel_bias[jnp.asarray(idx.reshape(-1))].reshape(n, n, heads)
    return jnp.transpose(bias, (2, 0, 1)).astype(jnp.float32)


def _window_partition(x: jnp.ndarray, ws: int) -> jnp.ndarray:
    """[B, H, W, C] -> [B * nW, ws*ws, C]."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c)
    x = jnp.transpose(x, (0, 1, 3, 2, 4, 5))
    return x.reshape(-1, ws * ws, c)


def _window_reverse(x: jnp.ndarray, ws: int, h: int, w: int) -> jnp.ndarray:
    b = x.shape[0] // ((h // ws) * (w // ws))
    x = x.reshape(b, h // ws, w // ws, ws, ws, -1)
    x = jnp.transpose(x, (0, 1, 3, 2, 4, 5))
    return x.reshape(b, h, w, -1)


def _window_attention(p: dict, x: jnp.ndarray, heads: int, ws: int, mask: np.ndarray | None):
    """x: [B_, N, C] windows -> attention with relative position bias."""
    b_, n, c = x.shape
    head_dim = c // heads
    qkv = common.linear(x, p["qkv"]["w"], p["qkv"]["b"])  # [B_, N, 3C]
    qkv = qkv.reshape(b_, n, 3, heads, head_dim)
    q, k, v = jnp.moveaxis(qkv, 2, 0)  # each [B_, N, heads, hd]
    q = jnp.transpose(q, (0, 2, 1, 3)) * (head_dim ** -0.5)
    k = jnp.transpose(k, (0, 2, 3, 1))
    v = jnp.transpose(v, (0, 2, 1, 3))
    # Attention logits, bias, and softmax run in float32 (preferred_element_type
    # promotes the QK^T accumulation); probabilities re-enter x.dtype so that
    # in bfloat16 mode the PV matmul and everything downstream stay bf16 — an
    # f32 result here would re-promote every later matmul in the block.
    attn = jnp.matmul(q, k, preferred_element_type=jnp.float32, precision=matmul_precision())
    attn = attn + _gathered_rel_bias(p["rel_bias"], ws, heads)[None]
    if mask is not None:
        nw = mask.shape[0]
        attn = attn.reshape(b_ // nw, nw, heads, n, n) + jnp.asarray(mask)[None, :, None]
        attn = attn.reshape(b_, heads, n, n)
    attn = jax.nn.softmax(attn, axis=-1).astype(x.dtype)
    out = jnp.matmul(attn, v, preferred_element_type=jnp.float32, precision=matmul_precision())
    out = jnp.transpose(out, (0, 2, 1, 3)).reshape(b_, n, c).astype(x.dtype)
    return common.linear(out, p["proj"]["w"], p["proj"]["b"])


def _swin_block(p: dict, x: jnp.ndarray, res: int, heads: int, shift: int) -> jnp.ndarray:
    """x: [B, L, C], pre-norm W-MSA/SW-MSA + MLP with residuals."""
    b, l, c = x.shape
    ws = WINDOW_SIZE
    shortcut = x
    h = common.layer_norm(x, **p["norm1"]).reshape(b, res, res, c)
    if shift:
        h = jnp.roll(h, (-shift, -shift), axis=(1, 2))
        mask = _shift_attn_mask(res, ws, shift)
    else:
        mask = None
    windows = _window_partition(h, ws)
    attn = _window_attention(p, windows, heads, ws, mask)
    h = _window_reverse(attn, ws, res, res)
    if shift:
        h = jnp.roll(h, (shift, shift), axis=(1, 2))
    x = shortcut + h.reshape(b, l, c)
    m = common.layer_norm(x, **p["norm2"])
    m = jax.nn.gelu(common.linear(m, **p["mlp"]["fc1"]), approximate=False)
    m = common.linear(m, **p["mlp"]["fc2"])
    return x + m


def _patch_merging(p: dict, x: jnp.ndarray, res: int) -> jnp.ndarray:
    """[B, res*res, C] -> [B, (res/2)^2, 2C]."""
    b, _, c = x.shape
    x = x.reshape(b, res, res, c)
    x = jnp.concatenate(
        [x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], axis=-1
    )
    x = x.reshape(b, (res // 2) * (res // 2), 4 * c)
    x = common.layer_norm(x, **p["norm"])
    return common.linear(x, p["reduction"]["w"])


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def clap_forward(params: dict, log_mel: jnp.ndarray) -> jnp.ndarray:
    """[B, 1001, 64] log-mel -> [B, 512] L2-normalized CLAP embeddings.

    FAD_TPU_PRECISION is resolved HERE, at call time, and folded into the
    jit key, so flipping it mid-process retraces instead of reusing the
    stale trace. Called inside an outer jit (pipeline core / shard_map),
    resolution happens at that trace's build time.
    """
    return _clap_forward_jit(params, log_mel, matmul_precision())


@functools.partial(jax.jit, static_argnames=("precision",))
def _clap_forward_jit(params: dict, log_mel: jnp.ndarray, precision) -> jnp.ndarray:
    # `precision` is consumed inside _window_attention/common at trace time
    # via config.matmul_precision(); it sits in the jit key only so an env
    # flip forces the retrace that re-reads it.
    del precision
    b, t, f = log_mel.shape
    # Bicubic 1001 -> 1024 time interpolation as four static gathers + a
    # weighted sum (see _bicubic_taps; fp-equivalent to the dense matmul).
    idx, w = _bicubic_taps(t, TARGET_T)
    idx, w = jnp.asarray(idx), jnp.asarray(w)
    x = None
    for k in range(4):
        term = w[:, k][None, :, None] * jnp.take(log_mel, idx[:, k], axis=1)
        x = term if x is None else x + term
    # bn0 over mel bins.
    x = common.batch_norm(x, params["bn0"])
    # reshape_wav2img: [B, 1024, 64] -> [B, 256, 256, 1].
    x = x.reshape(b, FREQ_RATIO, TARGET_T // FREQ_RATIO, MEL_BINS)  # [B, q, tt, f]
    x = jnp.transpose(x, (0, 1, 3, 2))  # [B, q, f, tt]
    x = x.reshape(b, SPEC_SIZE, SPEC_SIZE)[..., None]
    # Patch embed: 4x4/4 conv + LayerNorm. (The interpolation matmul promotes
    # to float32; re-enter the weights' dtype for bf16-mode compatibility.)
    pe = params["patch_embed"]
    x = x.astype(pe["conv"]["w"].dtype)
    x = common.conv2d(x, pe["conv"]["w"], pe["conv"]["b"], stride=(4, 4), padding="VALID")
    x = x.reshape(b, -1, EMBED_DIM)
    x = common.layer_norm(x, **pe["norm"])
    # Swin stages.
    for i, stage in enumerate(params["stages"]):
        res, heads = _STAGE_RES[i], NUM_HEADS[i]
        for j, blk in enumerate(stage["blocks"]):
            shift = 0 if (j % 2 == 0 or res <= WINDOW_SIZE) else WINDOW_SIZE // 2
            x = _swin_block(blk, x, res, heads, shift)
        if "downsample" in stage:
            x = _patch_merging(stage["downsample"], x, res)
    # Final norm + global token mean (HTSAT latent avgpool) + projection.
    # The embedding tail is tiny ([B, 768] onward) — run it in float32 even
    # in bf16 mode so the token mean and L2 normalization keep full precision.
    x = common.layer_norm(x, **params["norm"]).astype(jnp.float32)
    emb = jnp.mean(x, axis=1)  # [B, 768]
    proj = params["projection"]
    emb = jax.nn.relu(common.linear(emb, **proj["fc1"]))
    emb = common.linear(emb, **proj["fc2"])
    # torch F.normalize semantics: clamp the norm (eps=1e-12) so an exactly
    # zero embedding maps to the zero vector, not NaN (reference:
    # export_clap.py:149 uses F.normalize).
    return emb / jnp.maximum(jnp.linalg.norm(emb, axis=-1, keepdims=True), 1e-12)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _trunc_normal(rng, shape, std=0.02):
    return std * jax.random.truncated_normal(rng, -2.0, 2.0, shape, jnp.float32)


def init_clap_params(rng: jax.Array) -> dict:
    keys = iter(jax.random.split(rng, 256))
    params = {
        "bn0": common.init_batch_norm(MEL_BINS),
        "patch_embed": {
            "conv": {
                "w": _trunc_normal(next(keys), (PATCH_SIZE, PATCH_SIZE, 1, EMBED_DIM)),
                "b": jnp.zeros((EMBED_DIM,), jnp.float32),
            },
            "norm": common.init_layer_norm(EMBED_DIM),
        },
        "stages": [],
    }
    for i, depth in enumerate(DEPTHS):
        c, heads = _STAGE_DIMS[i], NUM_HEADS[i]
        blocks = []
        for _ in range(depth):
            blocks.append(
                {
                    "norm1": common.init_layer_norm(c),
                    "qkv": {
                        "w": _trunc_normal(next(keys), (c, 3 * c)),
                        "b": jnp.zeros((3 * c,), jnp.float32),
                    },
                    "rel_bias": _trunc_normal(
                        next(keys), ((2 * WINDOW_SIZE - 1) ** 2, heads)
                    ),
                    "proj": {
                        "w": _trunc_normal(next(keys), (c, c)),
                        "b": jnp.zeros((c,), jnp.float32),
                    },
                    "norm2": common.init_layer_norm(c),
                    "mlp": {
                        "fc1": {
                            "w": _trunc_normal(next(keys), (c, MLP_RATIO * c)),
                            "b": jnp.zeros((MLP_RATIO * c,), jnp.float32),
                        },
                        "fc2": {
                            "w": _trunc_normal(next(keys), (MLP_RATIO * c, c)),
                            "b": jnp.zeros((c,), jnp.float32),
                        },
                    },
                }
            )
        stage = {"blocks": blocks}
        if i < 3:
            stage["downsample"] = {
                "norm": common.init_layer_norm(4 * c),
                "reduction": {"w": _trunc_normal(next(keys), (4 * c, 2 * c))},
            }
        params["stages"].append(stage)
    params["norm"] = common.init_layer_norm(_STAGE_DIMS[-1])
    params["projection"] = {
        "fc1": {
            "w": _trunc_normal(next(keys), (_STAGE_DIMS[-1], EMBEDDING_SIZE)),
            "b": jnp.zeros((EMBEDDING_SIZE,), jnp.float32),
        },
        "fc2": {
            "w": _trunc_normal(next(keys), (EMBEDDING_SIZE, EMBEDDING_SIZE)),
            "b": jnp.zeros((EMBEDDING_SIZE,), jnp.float32),
        },
    }
    return params
