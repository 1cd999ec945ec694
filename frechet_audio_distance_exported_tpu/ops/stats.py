"""Embedding statistics and the Fréchet distance.

Three layers, fastest to most reference-exact:

1. **Streaming on-device accumulator** — single-pass (N, Σx, Σxxᵀ) with row
   masks, psum-able across a device mesh. Replaces the reference's
   np.mean/np.cov over a materialized embedding matrix
   (reference: fad.py:483-496) without ever gathering embeddings to host.
2. **On-device Fréchet distance** — trace(sqrtm(Σ₁Σ₂)) via either a
   symmetric-eigendecomposition route (robust default) or a scaled
   Newton–Schulz iteration (fast, matmul-only). Includes the reference's
   eps-diagonal-offset retry semantics for singular products
   (reference: fad.py:538-544).
3. **Host scipy path** — bit-for-bit the reference algorithm
   (scipy.linalg.sqrtm on the complex-cast product, non-finite retry with
   eps offset, imaginary-component check; reference: fad.py:498-555).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


# ---------------------------------------------------------------------------
# Streaming statistics
# ---------------------------------------------------------------------------


class StreamingStats(NamedTuple):
    """Single-pass accumulator: count, (shifted) sum, (shifted) outer products.

    ``shift`` is a fixed reference vector subtracted from every row before
    accumulation. A shift near E[x] turns the catastrophic cancellation of the
    naive non-centered second moment (ss - n*mu*mu^T, which costs ~3 decimal
    digits in float32) into a well-conditioned computation; the final (mu,
    sigma) are shift-invariant in exact arithmetic.
    """

    n: jnp.ndarray  # [] float32
    s: jnp.ndarray  # [d]
    ss: jnp.ndarray  # [d, d]
    shift: jnp.ndarray  # [d]


# Statistics stay full float32 on every backend: at DEFAULT/HIGH precision
# XLA:GPU runs float32 products as TF32 (10-bit operand mantissa), which
# would put ~1e-3 relative error into Σxxᵀ and the Fréchet epilogue.
STATS_PRECISION = jax.lax.Precision.HIGHEST


def init_stats(dim: int, dtype=jnp.float32, shift: Optional[jnp.ndarray] = None) -> StreamingStats:
    if shift is None:
        shift = jnp.zeros((dim,), dtype)
    return StreamingStats(
        n=jnp.zeros((), dtype),
        s=jnp.zeros((dim,), dtype),
        ss=jnp.zeros((dim, dim), dtype),
        shift=jnp.asarray(shift, dtype),
    )


@jax.jit
def update_stats(state: StreamingStats, x: jnp.ndarray, mask: jnp.ndarray) -> StreamingStats:
    """Accumulate a [..., d] chunk; mask [...] zeroes padded rows (leading
    dims are flattened inside the program, so callers can pass device arrays
    in their natural [B, P, d] shape without an eager reshape dispatch)."""
    x = x.reshape(-1, x.shape[-1])
    mask = mask.reshape(-1).astype(x.dtype)
    # where (not multiply): a NaN/Inf in a masked-out padded row must drop
    # out entirely — 0 * NaN is NaN and would poison every accumulator.
    xc = jnp.where(mask[:, None] > 0, x - state.shift, 0.0)
    return StreamingStats(
        n=state.n + jnp.sum(mask),
        s=state.s + jnp.sum(xc, axis=0),
        ss=state.ss + jnp.matmul(
            xc.T, xc, preferred_element_type=jnp.float32, precision=STATS_PRECISION
        ),
        shift=state.shift,
    )


@jax.jit
def init_update_stats(x: jnp.ndarray, mask: jnp.ndarray) -> StreamingStats:
    """First-chunk accumulation: compute the stabilizing shift (the chunk's
    masked mean) and fold the chunk in — one XLA program instead of separate
    shift/init/update dispatches."""
    x = x.reshape(-1, x.shape[-1])
    mask = mask.reshape(-1).astype(x.dtype)
    xm = jnp.where(mask[:, None] > 0, x, 0.0)  # NaN-proof masking (see update_stats)
    shift = jnp.sum(xm, axis=0) / jnp.maximum(jnp.sum(mask), 1.0)
    state = StreamingStats(
        n=jnp.zeros((), x.dtype),
        s=jnp.zeros((x.shape[-1],), x.dtype),
        ss=jnp.zeros((x.shape[-1], x.shape[-1]), x.dtype),
        shift=shift,
    )
    return update_stats(state, x, mask)


def finalize_stats(state: StreamingStats) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(μ, Σ) with the unbiased (N-1) normalization of np.cov(rowvar=False)
    (reference: fad.py:494-495)."""
    mu_c = state.s / state.n
    sigma = (state.ss - jnp.outer(mu_c, state.s)) / (state.n - 1.0)
    return mu_c + state.shift, sigma


def finalize_stats_np(state: StreamingStats) -> Tuple[np.ndarray, np.ndarray]:
    """float64 host finalization of a device accumulator — same math as
    finalize_stats, used by the device_stats scoring epilogue (the sums are
    tiny next to the embedding matrix, so float64 here is free)."""
    n = float(state.n)
    s = np.asarray(state.s, dtype=np.float64)
    ss = np.asarray(state.ss, dtype=np.float64)
    shift = np.asarray(state.shift, dtype=np.float64)
    mu_c = s / n
    sigma = (ss - np.outer(mu_c, s)) / (n - 1.0)
    return mu_c + shift, sigma


def calculate_embd_statistics_np(embd: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Host float64 reference-exact statistics (reference: fad.py:483-496)."""
    embd = np.asarray(embd)
    mu = np.mean(embd, axis=0)
    sigma = np.cov(embd, rowvar=False)
    return mu, sigma


# ---------------------------------------------------------------------------
# trace(sqrtm(Σ₁ Σ₂)) on device
# ---------------------------------------------------------------------------


@jax.jit
def _trace_sqrtm_product_eigh(sigma1: jnp.ndarray, sigma2: jnp.ndarray) -> jnp.ndarray:
    """trace(sqrtm(Σ₁Σ₂)) = Σ sqrt(eig(Σ₂^{1/2} Σ₁ Σ₂^{1/2})).

    The eigenvalues of Σ₁Σ₂ equal those of the symmetric PSD matrix
    Σ₂^{1/2} Σ₁ Σ₂^{1/2}; two eighs keep everything real and clampable.
    """
    mm = functools.partial(jnp.matmul, precision=STATS_PRECISION)
    w2, v2 = jnp.linalg.eigh(sigma2)
    sqrt_w2 = jnp.sqrt(jnp.maximum(w2, 0.0))
    b_half = mm(v2 * sqrt_w2[None, :], v2.T)
    inner = mm(mm(b_half, sigma1), b_half)
    inner = 0.5 * (inner + inner.T)
    w = jnp.linalg.eigvalsh(inner)
    return jnp.sum(jnp.sqrt(jnp.maximum(w, 0.0)))


@functools.partial(jax.jit, static_argnames=("num_iters",))
def _trace_sqrtm_product_ns(
    sigma1: jnp.ndarray, sigma2: jnp.ndarray, num_iters: int = 40
) -> jnp.ndarray:
    """trace(sqrtm(Σ₁Σ₂)) by scaled Newton–Schulz on A = Σ₂^{1/2}Σ₁Σ₂^{1/2}.

    Pure matmuls (no eigendecomposition kernel); the symmetric PSD A is formed with an
    NS square root of Σ₂ as well, so the whole path is eigendecomposition-free.
    """

    mm = functools.partial(jnp.matmul, precision=STATS_PRECISION)

    def ns_sqrt(a):
        norm = jnp.sqrt(jnp.sum(a * a))
        y = a / norm
        z = jnp.eye(a.shape[0], dtype=a.dtype)
        eye3 = 3.0 * jnp.eye(a.shape[0], dtype=a.dtype)

        def body(_, yz):
            y, z = yz
            t = 0.5 * (eye3 - mm(z, y))
            return (mm(y, t), mm(t, z))

        y, _ = jax.lax.fori_loop(0, num_iters, body, (y, z))
        return y * jnp.sqrt(norm)

    b_half = ns_sqrt(0.5 * (sigma2 + sigma2.T))
    inner = mm(mm(b_half, sigma1), b_half)
    inner = 0.5 * (inner + inner.T)
    s_half = ns_sqrt(inner)
    return jnp.trace(s_half)


# ---------------------------------------------------------------------------
# Fréchet distance
# ---------------------------------------------------------------------------


def frechet_distance_np(
    mu1: np.ndarray,
    sigma1: np.ndarray,
    mu2: np.ndarray,
    sigma2: np.ndarray,
    eps: float = 1e-6,
) -> float:
    """Reference-exact host path (reference: fad.py:498-555).

    Falls back to the eigh route (same math, ~1e-7 relative agreement) if
    scipy is not installed, rather than letting the ImportError be swallowed
    into the public API's -1 sentinel.
    """
    try:
        from scipy import linalg
    except ImportError:
        print(
            "[FAD-TPU] scipy not installed; using the eigh-based Fréchet "
            "distance (agrees with scipy.linalg.sqrtm to ~1e-7 relative)"
        )
        return frechet_distance_eigh_np(mu1, sigma1, mu2, sigma2, eps=eps)

    mu1 = np.atleast_1d(mu1)
    mu2 = np.atleast_1d(mu2)
    sigma1 = np.atleast_2d(sigma1)
    sigma2 = np.atleast_2d(sigma2)

    assert mu1.shape == mu2.shape, "Training and test mean vectors have different lengths"
    assert sigma1.shape == sigma2.shape, "Training and test covariances have different dimensions"

    diff = mu1 - mu2

    def _sqrtm(a):
        # scipy deprecated sqrtm's disp kwarg in 1.17 (removal slated for
        # 1.18): older scipy needs disp=False to suppress printing and
        # returns (sqrtm, errest); newer scipy returns the matrix alone.
        import warnings

        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", DeprecationWarning)
                out = linalg.sqrtm(a, disp=False)
            return out[0] if isinstance(out, tuple) else out
        except TypeError:  # scipy >= 1.18: disp removed
            return linalg.sqrtm(a)

    covmean = _sqrtm(sigma1.dot(sigma2).astype(complex))
    if not np.isfinite(covmean).all():
        print(
            "FID calculation produces singular product; "
            f"adding {eps} to diagonal of cov estimates"
        )
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = _sqrtm((sigma1 + offset).dot(sigma2 + offset).astype(complex))

    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            m = np.max(np.abs(covmean.imag))
            raise ValueError(f"Imaginary component {m}")
        covmean = covmean.real

    tr_covmean = np.trace(covmean)
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2) - 2 * tr_covmean)


def frechet_distance_eigh_np(
    mu1: np.ndarray,
    sigma1: np.ndarray,
    mu2: np.ndarray,
    sigma2: np.ndarray,
    eps: float = 1e-6,
) -> float:
    """Host float64 Fréchet distance via the symmetric-eigh route.

    Same math as the reference's scipy path (trace of the product square
    root) but ~50x faster at d=2048: two float64 eighs instead of a complex
    Schur sqrtm. Agrees with scipy to ~1e-7 relative; used by the
    device-stats scoring path where scipy's 30 s sqrtm would dominate
    end-to-end time.

    Singular products: the eigenvalue clamp (max(w, 0)) makes this route
    return the finite PSD-projected trace directly, so the reference's
    eps-diagonal RETRY condition (scipy sqrtm going non-finite,
    fad.py:538-544) can never fire here — an earlier version carried that
    retry as unreachable dead code (review r5). In the rare regime where
    scipy actually goes non-finite and the reference's retried score picks
    up an O(eps*d) offset, this route and the reference diverge by that
    offset; FAD_TPU_EXACT_SQRTM=1 runs the reference algorithm (retry
    included) bit-for-bit. ``eps`` is kept for signature compatibility.
    """
    del eps
    mu1 = np.atleast_1d(np.asarray(mu1, np.float64))
    mu2 = np.atleast_1d(np.asarray(mu2, np.float64))
    sigma1 = np.atleast_2d(np.asarray(sigma1, np.float64))
    sigma2 = np.atleast_2d(np.asarray(sigma2, np.float64))

    def trace_sqrtm(a, b):
        w2, v2 = np.linalg.eigh(0.5 * (b + b.T))
        b_half = (v2 * np.sqrt(np.maximum(w2, 0.0))) @ v2.T
        inner = b_half @ a @ b_half
        w = np.linalg.eigvalsh(0.5 * (inner + inner.T))
        return float(np.sum(np.sqrt(np.maximum(w, 0.0))))

    diff = mu1 - mu2
    tr = trace_sqrtm(sigma1, sigma2)
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2) - 2.0 * tr)


def frechet_distance_lowrank_np(emb1: np.ndarray, emb2: np.ndarray) -> float:
    """Exact Fréchet distance straight from the two embedding matrices,
    exploiting rank deficiency (the Gram trick).

    With centered X [n, d], Y [m, d]: Σ₁Σ₂ = XᵀX YᵀY / ((n-1)(m-1)) and the
    nonzero eigenvalues of XᵀX YᵀY equal those of (XYᵀ)(XYᵀ)ᵀ [n, n], so

        tr sqrtm(Σ₁Σ₂) = Σ σ_i(X Yᵀ) / sqrt((n-1)(m-1))

    — one [n, d] x [d, m] matmul + an n x m SVD instead of three d x d
    eigendecompositions. For PANN (d=2048) scored over 128 files this turns
    a multi-second epilogue into milliseconds, with NO approximation (same
    value as the scipy/eigh routes up to float64 rounding; the traces and
    the mean term come directly from X, Y as well). Used by score() when
    min(n, m) < d; the eigh/scipy routes handle the overdetermined case.
    """
    x = np.asarray(emb1, np.float64)
    y = np.asarray(emb2, np.float64)
    n, m = x.shape[0], y.shape[0]
    mu1 = x.mean(axis=0)
    mu2 = y.mean(axis=0)
    xc = x - mu1
    yc = y - mu2
    diff = mu1 - mu2
    tr1 = float(np.sum(xc * xc)) / (n - 1)
    tr2 = float(np.sum(yc * yc)) / (m - 1)
    cross = xc @ yc.T  # [n, m]
    sv = np.linalg.svd(cross, compute_uv=False)
    tr_covmean = float(np.sum(sv)) / np.sqrt((n - 1.0) * (m - 1.0))
    return float(diff.dot(diff) + tr1 + tr2 - 2.0 * tr_covmean)


@functools.partial(jax.jit, static_argnames=("method", "num_iters"))
def frechet_distance_jax(
    mu1: jnp.ndarray,
    sigma1: jnp.ndarray,
    mu2: jnp.ndarray,
    sigma2: jnp.ndarray,
    eps: float = 1e-6,
    method: str = "eigh",
    num_iters: int = 40,
) -> jnp.ndarray:
    """On-device Fréchet distance.

    Applies the reference's eps-diagonal retry (reference: fad.py:538-544)
    branchlessly: if the plain trace is non-finite, the eps-offset trace is
    used instead.
    """
    trace_fn = _trace_sqrtm_product_eigh if method == "eigh" else functools.partial(
        _trace_sqrtm_product_ns, num_iters=num_iters
    )
    diff = mu1 - mu2
    tr = trace_fn(sigma1, sigma2)
    if method != "eigh":
        # Non-finite retry through the eigh route: Newton-Schulz diverges on
        # (near-)singular products — exactly the case that lands here —
        # while eigh with the eps offset stays robust (measured at d=2048
        # rank-deficient: 6e-4 relative vs scipy). The eigh route itself
        # clamps eigenvalues and never goes non-finite, so for method='eigh'
        # this cond was dead code bloating the compiled program (review r5).
        eye = jnp.eye(sigma1.shape[0], dtype=sigma1.dtype) * eps
        tr = jax.lax.cond(
            jnp.isfinite(tr),
            lambda: tr,
            lambda: _trace_sqrtm_product_eigh(sigma1 + eye, sigma2 + eye),
        )
    return (
        jnp.dot(diff, diff, precision=STATS_PRECISION)
        + jnp.trace(sigma1) + jnp.trace(sigma2) - 2.0 * tr
    )
