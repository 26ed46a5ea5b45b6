"""Batched JAX k-mer kernels: rolling canonical packing + 32-bit hashing.

Bit-exact twins of kbbq_tpu/oracle/kmers.py (DECISIONS.md D1-D3, D5).
Design notes (SURVEY.md H3): k-mers are (hi, lo) uint32 lane pairs — the
32-bit arithmetic is part of the bit-exact spec (D1-D3) and needs no x64
mode; the packer is a length-L `lax.scan` carrying 4 uint32 lanes per
read, vectorized over the batch (elementwise work, O(B*L), vs O(B*L*k)
for naive per-window packing).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..constants import (
    FMIX32_C1,
    FMIX32_C2,
    HASH_SEED_H1,
    HASH_SEED_H2,
    HASH_SEED_SAMPLE,
)

_u32 = jnp.uint32


def fmix32(x: jax.Array) -> jax.Array:
    """murmur3 finalizer on uint32 arrays (oracle: kmers.fmix32)."""
    x = x.astype(_u32)
    x = x ^ (x >> 16)
    x = x * _u32(FMIX32_C1)
    x = x ^ (x >> 13)
    x = x * _u32(FMIX32_C2)
    x = x ^ (x >> 16)
    return x


def _shl64(hi, lo, s: int):
    """(hi, lo) << s for a static shift 0 <= s < 64 (2-lane u32 emulation)."""
    if s == 0:
        return hi, lo
    if s >= 32:
        return (lo << (s - 32)) if s > 32 else lo, jnp.zeros_like(lo)
    return (hi << s) | (lo >> (32 - s)), lo << s


@functools.partial(jax.jit, static_argnames=("k",))
def kmer_lanes_batch(codes: jax.Array, k: int):
    """Raw forward/RC lane pairs for every window of every read.

    Args:
      codes: int8 [B, L] base codes (4 = N/pad).
      k: static k-mer size (<= 32).
    Returns:
      (fhi, flo, rhi, rlo, valid): uint32 x4 + bool, each [B, n], n = L-k+1.
      Lane values of invalid windows are unspecified.

    Built by LOG-DOUBLING, not a length-L `lax.scan`: segment packs of
    width w combine pairwise into width-2w packs via static rolls and
    2-lane shift-ors, so the whole batch packs in ~log2(k) full-width
    vector steps.  The scan formulation emitted ~25 sub-us ops per base
    position; at the walk's 256-lane chunk width that per-op overhead
    dominated pass-3 wall time (device trace, docs/PERF.md round 2).
    Window j takes only positions [j, j+k), so the circular roll wrap
    never reaches a valid window.  The fast inference kernel patches
    these lanes in place on substitution (O(1) per window).
    """
    B, L = codes.shape
    n = L - k + 1
    assert n >= 1, "read length must be >= k"

    c32 = jnp.where(codes < 4, codes, 0).astype(_u32)
    comp = _u32(3) - c32
    bvalid = codes < 4
    z = jnp.zeros_like(c32)

    roll = lambda a, off: jnp.roll(a, -off, axis=1) if off else a

    # segment packs by doubling: fwd[w][i] = bases [i, i+w) packed 2-bit
    # big-endian; rc[w][i] = complemented bases [i, i+w) packed reversed;
    # val[w][i] = all w bases valid
    fwd = {1: (z, c32)}
    rc = {1: (z, comp)}
    val = {1: bvalid}
    w = 1
    while w < k:
        fh, fl = fwd[w]
        rh, rl = rc[w]
        sh, sl = _shl64(fh, fl, 2 * w)
        fwd[2 * w] = (sh | roll(fh, w), sl | roll(fl, w))
        th, tl = _shl64(roll(rh, w), roll(rl, w), 2 * w)
        rc[2 * w] = (th | rh, tl | rl)
        val[2 * w] = val[w] & roll(val[w], w)
        w *= 2

    # compose k from its binary decomposition (MSB first)
    fhi = flo = rhi = rlo = None
    valid = None
    acc_w = 0
    for p in sorted(fwd, reverse=True):
        if not (k & p):
            continue
        fh, fl = (roll(fwd[p][0], acc_w), roll(fwd[p][1], acc_w))
        rh, rl = (roll(rc[p][0], acc_w), roll(rc[p][1], acc_w))
        v = roll(val[p], acc_w)
        if fhi is None:
            fhi, flo, rhi, rlo, valid = fh, fl, rh, rl, v
        else:
            fhi, flo = _shl64(fhi, flo, 2 * p)
            fhi, flo = fhi | fh, flo | fl
            # reversed pack: later (rightmost) segment goes HIGH
            rh2, rl2 = _shl64(rh, rl, 2 * acc_w)
            rhi, rlo = rhi | rh2, rlo | rl2
            valid = valid & v
        acc_w += p
    return (fhi[:, :n], flo[:, :n], rhi[:, :n], rlo[:, :n], valid[:, :n])


def canonical_from_lanes(fhi, flo, rhi, rlo):
    """min(forward, rc) by (hi, lo) unsigned compare (oracle D2)."""
    fwd_le = (fhi < rhi) | ((fhi == rhi) & (flo <= rlo))
    return jnp.where(fwd_le, fhi, rhi), jnp.where(fwd_le, flo, rlo)


@functools.partial(jax.jit, static_argnames=("k",))
def canonical_kmers_batch(codes: jax.Array, k: int):
    """Canonical k-mers for every window of every read.

    Returns (hi, lo, valid): uint32/uint32/bool [B, n] with n = L-k+1.
    Matches oracle canonical_kmers exactly.
    """
    fhi, flo, rhi, rlo, valid = kmer_lanes_batch(codes, k)
    hi, lo = canonical_from_lanes(fhi, flo, rhi, rlo)
    return hi, lo, valid


def kmer_hashes(hi: jax.Array, lo: jax.Array):
    """(h1, h2): block selector / in-block offsets (oracle: kmer_hashes)."""
    hi = hi.astype(_u32)
    lo = lo.astype(_u32)
    h1 = fmix32(lo ^ fmix32(hi ^ _u32(HASH_SEED_H1)))
    h2 = fmix32(hi ^ fmix32(lo ^ _u32(HASH_SEED_H2)))
    return h1, h2


def sample_keep_mask(read_ids: jax.Array, num_windows: int,
                     threshold) -> jax.Array:
    """Per-occurrence sampling decisions (oracle: sample_hash; D5).

    Args:
      read_ids: uint32 [B] global read ordinals.
      num_windows: static window count n.
      threshold: uint32 scalar (inclusive keep threshold).
    Returns: bool [B, n].
    """
    r = read_ids.astype(_u32)[:, None]
    j = jax.lax.broadcasted_iota(_u32, (1, num_windows), 1)
    s = fmix32(fmix32(r ^ _u32(HASH_SEED_SAMPLE)) ^ (j * _u32(0x9E3779B9)))
    return s <= _u32(threshold)
