"""Sharded embedding + statistics: the fused multi-device scoring step.

This is the communication layer the reference lacks (SURVEY.md §5.8): shard
the batch over a 1-D mesh with shard_map, run frontend + embedding network
per shard, reduce the streaming statistics with psum across devices, and
(optionally) finish with the on-device Fréchet epilogue — one jitted
program, no host round-trips, deterministic reduction order.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..ops import stats as stats_ops
from .mesh import DATA_AXIS


def make_sharded_embed_stats(
    mesh: Mesh, model_fn: Callable, check_vma: bool = True
) -> Callable[[dict, jnp.ndarray, jnp.ndarray], stats_ops.StreamingStats]:
    """Build fn(params, rows, mask) -> StreamingStats, batch sharded over 'data'.

    Pass check_vma=False when ``model_fn`` trips jax's varying-manual-axes
    lint (the EnCodec LSTM's scan carry does); other models keep the lint.

    ``rows`` [B, ...] are model inputs (patches / log-mels / waveforms),
    ``mask`` [B] zeroes padded rows. The statistics are psum-reduced and
    replicated on every device.

    Numerics: the embeddings are materialized once per shard, the global
    masked mean is psum'd first ([d] vector — negligible traffic next to the
    [d, d] psum), and the second moment is accumulated CENTERED at that mean
    (shift = exact global mean). This is a two-pass covariance fused into one
    program: no float32 cancellation, so the multi-chip score stays inside
    the <=1e-3 parity bar instead of drifting percent-level as a shift=0
    accumulation would.
    """

    def _local(params, rows, mask):
        emb = model_fn(params, rows)
        # where (not multiply) so a NaN in a masked padded row drops out.
        emb = jnp.where(mask[:, None] > 0, emb, 0.0)
        n = jax.lax.psum(jnp.sum(mask), DATA_AXIS)
        s_raw = jax.lax.psum(jnp.sum(emb, axis=0), DATA_AXIS)
        mu = s_raw / jnp.maximum(n, 1.0)
        emb_c = jnp.where(mask[:, None] > 0, emb - mu, 0.0)
        ss = jax.lax.psum(
            jnp.matmul(
                emb_c.T, emb_c, preferred_element_type=jnp.float32,
                precision=stats_ops.STATS_PRECISION,
            ),
            DATA_AXIS,
        )
        s_c = s_raw - n * mu  # == 0 up to rounding; keeps finalize_stats exact
        return n, s_c, ss, mu

    sharded = jax.shard_map(
        _local,
        mesh=mesh,
        in_specs=(P(), P(DATA_AXIS), P(DATA_AXIS)),
        out_specs=(P(), P(), P(), P()),
        check_vma=check_vma,
    )

    @jax.jit
    def fn(params, rows, mask):
        n, s, ss, mu = sharded(params, rows, mask)
        return stats_ops.StreamingStats(n=n, s=s, ss=ss, shift=mu)

    return fn


def make_sharded_score_step(
    mesh: Mesh, model_fn: Callable, check_vma: bool = True
) -> Callable:
    """Build the full fused scoring step:

    fn(params, rows_bg, mask_bg, rows_ev, mask_ev) -> FAD scalar

    Both row sets are sharded over 'data'; statistics are psum'd; the Fréchet
    epilogue (finalize + eigh trace-sqrtm) runs replicated on device. This is
    the multi-chip production path and the dryrun_multichip target.
    """
    embed_stats = make_sharded_embed_stats(mesh, model_fn, check_vma=check_vma)

    @jax.jit
    def step(params, rows_bg, mask_bg, rows_ev, mask_ev):
        mu1, sig1 = stats_ops.finalize_stats(embed_stats(params, rows_bg, mask_bg))
        mu2, sig2 = stats_ops.finalize_stats(embed_stats(params, rows_ev, mask_ev))
        return stats_ops.frechet_distance_jax(mu1, sig1, mu2, sig2)

    return step
