"""JAX Bloom filter ops — BLOCKED bit-packed layout (D3/D4).

All h probes of a k-mer live in one 32-bit block word, so a query costs
ONE random HBM word fetch + in-register bit tests (SURVEY.md H4).
INSERT passes scatter-set single bytes into a uint8 staging array (no
read-modify-write: all writes store 1, so collisions commute and sharding
cannot change the result, SURVEY.md H5); `bloom_rows` packs the staging
bytes into uint32 block words once per pass boundary via an exact bf16
matmul.  The oracle's byte array is the staging view of the same bits —
byte-level semantics are identical.

Twin: oracle/bloom.py + oracle/kmers.py::probe_positions.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .kmers import kmer_hashes

_u32 = jnp.uint32


def hash_offsets(h2: jax.Array, num_hashes: int) -> jax.Array:
    """int32 [..., h] in-word bit offsets from the second hash (D3)."""
    s = (jax.lax.broadcasted_iota(_u32, (num_hashes,), 0) * _u32(5)) \
        & _u32(31)
    rot = (h2[..., None] >> s) | (h2[..., None] << ((_u32(32) - s)
                                                    & _u32(31)))
    return (rot & _u32(31)).astype(jnp.int32)


def probe_positions_h(h1: jax.Array, h2: jax.Array, num_hashes: int,
                      log2_m: int) -> jax.Array:
    """probe_positions from precomputed (h1, h2) hashes."""
    block = h1 & _u32((1 << (log2_m - 5)) - 1)
    off = hash_offsets(h2, num_hashes).astype(_u32)
    return (block[..., None] << _u32(5)) | off


def probe_positions(hi: jax.Array, lo: jax.Array, num_hashes: int,
                    log2_m: int) -> jax.Array:
    """uint32 [..., num_hashes] slot indices (oracle: probe_positions)."""
    h1, h2 = kmer_hashes(hi, lo)
    return probe_positions_h(h1, h2, num_hashes, log2_m)


def block_and_offsets_h(h1: jax.Array, h2: jax.Array, num_hashes: int,
                        log2_m: int):
    """(block [...], off [..., h]) from precomputed (h1, h2) hashes.

    block is int32: valid through log2_m = 36 (< 2^31 blocks), the
    layout's addressing ceiling (constants.MAX_BLOOM_LOG2)."""
    assert log2_m <= 36, "block indices overflow int32 past 2^36 slots"
    block = (h1 & _u32((1 << (log2_m - 5)) - 1)).astype(jnp.int32)
    return block, hash_offsets(h2, num_hashes)


def block_and_offsets(hi: jax.Array, lo: jax.Array, num_hashes: int,
                      log2_m: int):
    """(block [...], off [..., h]) for row-wise queries."""
    h1, h2 = kmer_hashes(hi, lo)
    return block_and_offsets_h(h1, h2, num_hashes, log2_m)


def bloom_insert(slots: jax.Array, hi: jax.Array, lo: jax.Array,
                 mask: jax.Array, num_hashes: int) -> jax.Array:
    """Set probe slots for masked k-mers. slots: uint8 [m] (donated).

    Masked-out entries are routed out of bounds and dropped.
    """
    m = slots.shape[0]
    log2_m = int(m).bit_length() - 1
    assert (1 << log2_m) == m, "bloom size must be a power of two"
    # int32 slot positions: the staging layout caps at 2^31 slots; the
    # dense/packed builds (probe_words + bloom_rows_dense) go to 2^36
    assert log2_m <= 31, "staging insert overflows int32 slot positions"
    pos = probe_positions(hi, lo, num_hashes, log2_m).astype(jnp.int32)
    oob = jnp.int32(m)
    pos = jnp.where(mask[..., None], pos, oob)
    # fence the index math out of the scatter; its body then only reads
    # precomputed indices and stores the constant 1
    pos = jax.lax.optimization_barrier(pos.reshape(-1))
    return slots.at[pos].set(
        jnp.uint8(1), mode="drop", indices_are_sorted=False,
        unique_indices=False)


def bloom_insert_rows(slots: jax.Array, hi: jax.Array, lo: jax.Array,
                      mask: jax.Array, num_hashes: int) -> jax.Array:
    """bloom_insert with ONE scatter iteration per k-mer (not per probe).

    All `num_hashes` probe bits of a k-mer live in one 32-bit block word
    (D3), i.e. within one aligned 32-byte span of the staging array — so
    we build each k-mer's 0/1 byte pattern vectorized as a 128-byte row
    and scatter-MAX whole rows: num_hashes x fewer scatter indices, and
    max over {0,1} bytes
    is OR, so the final staging bytes are identical to bloom_insert's
    (and remain shard-order-invariant: max commutes).
    """
    m = slots.shape[0]
    log2_m = int(m).bit_length() - 1
    assert (1 << log2_m) == m and m % 128 == 0
    assert log2_m <= 31, "staging insert overflows int32 slot positions"
    block, off = block_and_offsets(hi, lo, num_hashes, log2_m)
    block = block.reshape(-1)
    off = off.reshape(-1, num_hashes)
    rowidx = block >> 2                       # 128-byte staging row
    tgt = (block & 3)[:, None] * 32 + off     # byte lanes within the row
    lane = jax.lax.broadcasted_iota(jnp.int32, (1, 128), 1)
    # OR of num_hashes [N, 128] one-hot compares (fused 2-D), not one
    # [N, 128, h] broadcast with a tiny minor dim
    hit = lane == tgt[:, 0:1]
    for j in range(1, num_hashes):
        hit = hit | (lane == tgt[:, j:j + 1])
    row = hit.astype(jnp.uint8)
    rowidx = jnp.where(mask.reshape(-1), rowidx, jnp.int32(m // 128))
    rowidx, row = jax.lax.optimization_barrier((rowidx, row))
    out = slots.reshape(m // 128, 128).at[rowidx].max(
        row, mode="drop", unique_indices=False)
    return out.reshape(m)


def probe_word(h2: jax.Array, num_hashes: int) -> jax.Array:
    """The 32-bit OR of a k-mer's probe bits from its second hash.

    Depends ONLY on h2 — filter-size independent, so one (h1, word)
    pair serves filters of any log2_m (block = h1 & (2^(log2_m-5)-1));
    the resident pipeline caches these across passes 1-3.  Never zero:
    at least one probe bit is set, so callers may use word == 0 as an
    invalid-window sentinel."""
    w = jnp.zeros_like(h2)
    for j in range(num_hashes):
        s = _u32((j * 5) & 31)
        rot = (h2 >> s) | (h2 << ((_u32(32) - s) & _u32(31)))
        w = w | (_u32(1) << (rot & _u32(31)))
    return w


def probe_words_h(h1: jax.Array, h2: jax.Array, num_hashes: int,
                  log2_m: int):
    """probe_words from precomputed (h1, h2) hashes (uint32 block —
    valid through the log2_m = 36 addressing ceiling)."""
    assert log2_m <= 36
    block = h1 & _u32((1 << (log2_m - 5)) - 1)
    return block, probe_word(h2, num_hashes)


def probe_words(hi: jax.Array, lo: jax.Array, num_hashes: int,
                log2_m: int):
    """(block, word) per k-mer: the packed-row word index and the 32-bit
    OR of its probe bits — same bit layout as bloom_rows(bloom_insert's
    staging), i.e. packed[block] |= word reproduces the filter."""
    h1, h2 = kmer_hashes(hi, lo)
    return probe_words_h(h1, h2, num_hashes, log2_m)


def bloom_rows_dense(block: jax.Array, w: jax.Array, mask: jax.Array,
                     log2_m: int) -> jax.Array:
    """Packed filter (uint32 [m/32]) from per-k-mer (block, word) pairs
    via sort + segmented OR + compaction sort + one unique scatter.

    Instead of one scatter index per k-mer slot, only the <= M segment-
    last entries scatter.  (A searchsorted of all M word indices into
    the sorted keys scales with M x log n; the compaction sort does
    not.)

    Exactness: sort groups equal blocks; the running OR within a
    segment is numerically MONOTONE (a|b >= a unsigned), so the
    segment-last running-OR value IS the full OR of the segment.  The
    second sort moves exactly the segment-last pairs (one per distinct
    block, <= M of them) to the front in block order; everything else
    carries sentinel key M and is dropped by the scatter (index M is
    out of bounds for the [M] output).  Masked k-mers get sentinel
    block M after the first sort too, so they join a trailing segment
    whose last entry also carries key M and is dropped.
    """
    M = 1 << (log2_m - 5)
    bs, ws = jax.lax.sort(
        (jnp.where(mask, block, _u32(M)),
         jnp.where(mask, w, _u32(0))), num_keys=1)
    return _rows_from_sorted(bs, ws, M)


def bloom_rows_dense_prefixed(block: jax.Array, w: jax.Array,
                              mask: jax.Array, log2_m: int,
                              prefix: int):
    """bloom_rows_dense where at most `prefix` entries are expected to
    be masked-in (e.g. pass-1's alpha-sampled slots): the OR-scan,
    compaction sort, and scatter run on the sorted prefix only —
    ~1/alpha x less work after the first sort.  Returns (rows,
    kept_count); the result is only valid when kept_count <= prefix
    (sort puts masked-in entries first), so the CALLER must check and
    fall back to bloom_rows_dense on overflow.
    """
    M = 1 << (log2_m - 5)
    bs, ws = jax.lax.sort(
        (jnp.where(mask, block, _u32(M)),
         jnp.where(mask, w, _u32(0))), num_keys=1)
    cnt = jnp.sum(mask.astype(jnp.int32))
    P = min(max(prefix, 1), bs.shape[0])
    return _rows_from_sorted(bs[:P], ws[:P], M), cnt


def sorted_unique_pairs(bs: jax.Array, ws: jax.Array, M: int):
    """(kp int32 [P], vp u32 [P]) unique block -> OR(words) pairs from
    block-sorted (bs, ws) with sentinel M sorting last; P = min(M+1, n).
    Sentinel entries keep key M (>= M, out of bounds for an [M]
    scatter in drop mode).  Shared by the single-array packed build and
    the sharded per-shard OR-merge."""
    # sentinel M must stay a positive int32 (the scatter's sorted-hint
    # requires monotone indices): single-ARRAY builds cap at 2^35 slots
    # (M = 2^30 words); a log2_m = 36 filter builds per shard
    assert M < (1 << 31), "single-array build caps at 2^35 slots"
    n = bs.shape[0]
    # segmented inclusive OR-scan, manual Hillis-Steele (log2 n static
    # shifts; lax.associative_scan's recursive build did not finish
    # compiling at 48M elements)
    v = ws
    f0 = jnp.concatenate([jnp.ones((1,), bool), bs[1:] != bs[:-1]])
    f = f0
    d = 1
    while d < n:
        pv = jnp.concatenate([jnp.zeros((d,), _u32), v[:-d]])
        pf = jnp.concatenate([jnp.ones((d,), bool), f[:-d]])
        v = jnp.where(f, v, v | pv)
        f = f | pf
        d <<= 1
    # segment-last flags from the ORIGINAL boundaries
    is_last = jnp.concatenate([f0[1:], jnp.ones((1,), bool)])
    key2 = jnp.where(is_last, bs, _u32(M))      # sentinels sort last
    ks, vs = jax.lax.sort((key2, v), num_keys=1)
    P = min(M + 1, n)        # at most one segment-last per block value
    kp = ks[:P].astype(jnp.int32)               # ascending, uniques first
    vp = vs[:P]
    return jax.lax.optimization_barrier((kp, vp))


def _rows_from_sorted(bs: jax.Array, ws: jax.Array, M: int) -> jax.Array:
    """Packed rows from block-sorted (bs, ws) pairs (sentinel M last)."""
    kp, vp = sorted_unique_pairs(bs, ws, M)
    return jnp.zeros(M, _u32).at[kp].set(
        vp, mode="drop", indices_are_sorted=True, unique_indices=False)


@jax.jit
def bloom_rows(slots: jax.Array) -> jax.Array:
    """Pack the byte filter into bit-blocks: uint32 [m/32], word b's bit j
    = slots[b*32 + j].  Built once per pass boundary.

    Packing is a matrix product: bytes (0/1) x power-of-two weights are
    exact in bf16, accumulated in f32 (sums < 2^16) — one [m/512, 512] x
    [512, 32] matmul instead of 32 stride-32 slices; it reads m bytes
    once.
    """
    m = slots.shape[0]
    assert m % 512 == 0, "bloom size must be a multiple of 512 slots"
    b = slots.reshape(m // 512, 512).astype(jnp.bfloat16)
    # weights: column c contributes 2^(c%32 mod 16) to word (c//32) of
    # its half; build [512, 32] lo/hi weight matrices
    c = np.arange(512)
    w_idx = c // 32          # which of the 16 words in this row
    bit = c % 32
    wlo = np.zeros((512, 16), dtype=np.float32)
    whi = np.zeros((512, 16), dtype=np.float32)
    for ci in range(512):
        if bit[ci] < 16:
            wlo[ci, w_idx[ci]] = float(1 << bit[ci])
        else:
            whi[ci, w_idx[ci]] = float(1 << (bit[ci] - 16))
    lo = jnp.dot(b, jnp.asarray(wlo, dtype=jnp.bfloat16),
                 preferred_element_type=jnp.float32)
    hi = jnp.dot(b, jnp.asarray(whi, dtype=jnp.bfloat16),
                 preferred_element_type=jnp.float32)
    word = lo.astype(_u32) | (hi.astype(_u32) << _u32(16))
    return word.reshape(m // 32)


def bloom_query_rows(packed: jax.Array, hi: jax.Array, lo: jax.Array,
                     num_hashes: int) -> jax.Array:
    """Membership per k-mer via ONE uint32-word gather each: bool [...].

    packed: uint32 [m/32] from bloom_rows; all h probe bits live in the
    k-mer's single block word (D3).
    """
    log2_m = int(packed.shape[0] * 32).bit_length() - 1
    block, off = block_and_offsets(hi, lo, num_hashes, log2_m)
    # the fetch stays fused with the index math: an optimization_barrier
    # here would materialize the index/word arrays to device memory
    word = packed[block]                    # [...] one fetch per k-mer
    bits = (word[..., None] >> off.astype(_u32)) & _u32(1)
    return jnp.min(bits, axis=-1) > 0


def bloom_query(slots: jax.Array, hi: jax.Array, lo: jax.Array,
                num_hashes: int) -> jax.Array:
    """Byte-level query (semantic reference; h gathers).  The pipeline
    uses bloom_query_rows on a prebuilt row view instead."""
    m = slots.shape[0]
    log2_m = int(m).bit_length() - 1
    pos = probe_positions(hi, lo, num_hashes, log2_m).astype(jnp.int32)
    got = slots[pos]
    return jnp.min(got, axis=-1) > 0
