"""Pass-2 JAX kernels: coverage rule + trusted-k-mer mask (D6).

Twin: oracle/lighter.py coverage_mask / trusted_kmer_mask.  Sliding-window
sums are prefix-sum differences (integer adds — exact, shard-invariant).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def _window_sum_full(x: jax.Array, k: int) -> jax.Array:
    """Full-convolution sliding sum: out[i] = sum x[j], j in [i-k+1, i]
    clipped to [0, n).  x: int32 [B, n] -> int32 [B, n+k-1].

    The clipped index vectors are piecewise-affine, so the two cumsum
    reads are static slices + edge broadcasts — no gather."""
    B, n = x.shape
    cs = jnp.concatenate(
        [jnp.zeros((B, 1), x.dtype), jnp.cumsum(x, axis=1)], axis=1)
    # top[i] = min(i+1, n): cols 1..n then col n repeated k-1 times
    top = jnp.concatenate(
        [cs[:, 1:n + 1],
         jnp.broadcast_to(cs[:, n:n + 1], (B, k - 1))], axis=1)
    # bot[i] = clip(i-k+1, 0, n): col 0 repeated k times, then 1..n-1
    bot = jnp.concatenate(
        [jnp.broadcast_to(cs[:, 0:1], (B, k)), cs[:, 1:n]], axis=1)
    return top - bot


def _window_sum_valid(x: jax.Array, k: int) -> jax.Array:
    """Valid-convolution sliding sum: out[j] = sum x[j..j+k-1].
    x: int32 [B, L] -> int32 [B, L-k+1].  Static slices, no gather."""
    B, L = x.shape
    cs = jnp.concatenate(
        [jnp.zeros((B, 1), x.dtype), jnp.cumsum(x, axis=1)], axis=1)
    return cs[:, k:] - cs[:, :L - k + 1]


@functools.partial(jax.jit, static_argnames=("k",))
def coverage_counts(hits: jax.Array, valid: jax.Array, k: int):
    """(s, x) per base: A-positive / valid overlapping-window counts.

    hits, valid: bool [B, n] per-window; returns int32 [B, L] each
    (L = n+k-1).  Matches the oracle's full-mode convolutions.
    """
    s = _window_sum_full(hits.astype(jnp.int32), k)
    x = _window_sum_full(valid.astype(jnp.int32), k)
    return s, x


@functools.partial(jax.jit, static_argnames=("k", "trust_threshold"))
def trusted_mask_batch(hits: jax.Array, valid: jax.Array,
                       thresholds: jax.Array, k: int,
                       trust_threshold: int | None = None) -> jax.Array:
    """Pass-2 trusted mask per window (D6).

    Args:
      hits: bool [B, n] filter-A membership per window.
      valid: bool [B, n] window validity.
      thresholds: int32 [k+1] coverage threshold table t(x) (host-computed
        from scipy binom, oracle coverage_thresholds).
    Returns: bool [B, n].
    """
    s, x = coverage_counts(hits, valid, k)
    # thresholds[x] as a k+1-step select chain instead of a [B, L]
    # gather from the tiny table; x is bounded by k+1 values so static
    # compares fuse into cheap vector selects
    th = jnp.zeros_like(s)
    for t in range(thresholds.shape[0]):
        th = jnp.where(x == t, thresholds[t], th)
    covered = s >= th
    T = k if trust_threshold is None else trust_threshold
    covc = _window_sum_valid(covered.astype(jnp.int32), k)
    return valid & (covc >= T)
