"""Device-resident single-chip pipeline: one jit dispatch per pass.

The batched pipeline (pipeline/recalibrate.py) dispatches one jitted
step per batch.  This variant puts the whole dataset on device ONCE
(400k x 150 reads = 60 MB int8 codes) and runs each pass as a single
jit containing a `lax.scan` over batch slices, so per-pass
host<->device traffic is one dispatch + one small result.
Bit-identical to the batched pipeline (same step math, same batch
widths, same ordinals).

Used by bench.py and run_pipeline when the dataset fits the device's
resident budget (utils/mem.py::device_budget); the streaming paths
remain the story for datasets larger than device memory.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..io.batcher import ReadArrays
from ..oracle.bloom import BloomParams
from ..oracle.gatk import build_recal_table
from ..oracle.kmers import alpha_threshold
from ..oracle.lighter import coverage_thresholds
from ..ops.bloom import bloom_insert_rows, bloom_query_rows, \
    bloom_rows, bloom_rows_dense, probe_words
from ..ops.covariate import accumulate_covariates, new_covariate_state
from ..ops.inference import WALK_CHUNK, infer_errors
from ..ops.kmers import canonical_kmers_batch, sample_keep_mask
from ..ops.recal import apply_recal_table, apply_recal_table_host
from ..ops.trusted import trusted_mask_batch
from ..utils.mem import device_budget
from .recalibrate import RecalConfig

# dense sort-build (vs scatter insert): the resident path stages the
# (block, word, mask) k-mer triples (~9 B/k-mer; E. coli-full is
# ~1.6 GB) when they fit device_budget("dense_build"); larger datasets
# use the scatter scan path.

# pass-1 sampled-prefix bound: P = Ns * alpha * SLACK + PAD per slice
# (counter-hash Bernoulli keeps concentrate far below it; overflow falls
# back to the uncompacted build — module-level so tests can force it)
SAMPLE_PREFIX_SLACK = 1.25
_SAMPLE_PREFIX_PAD = 4096


def _pack_quarters(codes: np.ndarray) -> np.ndarray:
    """2-bit-pack a [N, L] code array into [N, ceil(L/4)] bytes.

    Byte j holds codes[j], codes[j+Lq], codes[j+2Lq], codes[j+3Lq] in
    consecutive 2-bit fields (quarter planes, NOT interleaved), so the
    device-side unpack is a pure lane concatenate — no strided scatter,
    no 3-D intermediates.  N bases (code 4) don't fit 2 bits; the
    caller ships their positions as a sparse int32 list and re-scatters
    4s on device — N bases are rare in real data, and the split quarters
    the dominant host->device transfer.  Padding rows/columns need no
    entries: the device mask (from per-read lengths) re-marks them.

    All temporaries are in-place ops over two hugepage-advised quarter
    buffers: the expression form allocated ~5 fresh [N, L]-scale temps
    per slice, each re-paying this host's episodic first-touch fault
    storm (utils/mem.py, KNOWN_ISSUES #2).
    """
    from ..utils.mem import hugepage_empty
    N, L = codes.shape
    Lq = (L + 3) // 4
    cu = codes.view(np.uint8) if codes.dtype == np.int8 else \
        codes.astype(np.uint8)

    def quarter(out, j):
        """out[:] = (codes[:, j*Lq:(j+1)*Lq] & 3), zero-padded."""
        s = j * Lq
        e = min(L, s + Lq)
        if e <= s:
            out[:] = 0
            return out
        w = e - s
        np.bitwise_and(cu[:, s:e], 3, out=out[:, :w])
        if w < Lq:
            out[:, w:] = 0
        return out

    out = hugepage_empty((N, Lq), np.uint8)
    q = hugepage_empty((N, Lq), np.uint8)
    quarter(out, 3)
    out <<= 2
    out |= quarter(q, 2)
    out <<= 2
    out |= quarter(q, 1)
    out <<= 2
    out |= quarter(q, 0)
    return out


@functools.partial(jax.jit, static_argnames=("L", "n_real"))
def _expand_inputs(packed, n_pos, lens, off, *, L, n_real):
    """Device-side reconstruction of codes/mask/ids from the packed feed
    (one row SLICE of the dataset; `off` = first global row of the
    slice, n_pos are slice-relative flat positions).

    codes: unpack the four 2-bit quarter planes and lane-concatenate
    (bit-exact inverse of _pack_quarters), re-mark everything past each
    read's length as 4 via the mask, then scatter 4 at the sparse
    in-read N positions.  mask: prefix mask from per-read lengths
    (io/batcher.py builds mask as `mask[i, :len] = True`, so lengths are
    a lossless encoding at 1/8L the bytes).  ids: global read ordinals,
    0xFFFFFFFF for padding rows (excluded from sampling).
    """
    npad = packed.shape[0]
    planes = [((packed >> s) & 3).astype(jnp.int8) for s in (0, 2, 4, 6)]
    codes = jnp.concatenate(planes, axis=1)[:, :L]
    pos = jax.lax.broadcasted_iota(jnp.int32, (npad, L), 1)
    mask = pos < lens[:, None].astype(jnp.int32)
    codes = jnp.where(mask, codes, jnp.int8(4))
    if n_pos.shape[0]:
        codes = codes.reshape(-1).at[n_pos].set(
            jnp.int8(4), mode="drop").reshape(npad, L)
    r = off.astype(jnp.uint32) + jnp.arange(npad, dtype=jnp.uint32)
    ids = jnp.where(r < np.uint32(n_real), r, jnp.uint32(0xFFFFFFFF))
    return codes, mask, ids


def _pad_to_batches(arrays: ReadArrays, B: int, num_slices: int = 8):
    """Stage arrays on device, padded to a whole number of batches.

    Minimizes host->device bytes: codes go 2-bit packed (4x), the [N, L]
    mask goes as uint16 lengths (16x), ids are derived on device.  The
    codes feed is split into up to `num_slices` contiguous batch groups
    whose transfers run on a background thread: the caller overlaps
    pass-1 compute on slice i with the h2d of slice i+1.  quals ship
    asynchronously too — the caller joins them only after the pass-3
    walk dispatch.
    """
    N = arrays.num_reads
    nb = max(1, (N + B - 1) // B)
    pad = nb * B - N
    L = arrays.max_len

    def p2(a, fill):
        if not pad:
            return a
        return np.concatenate(
            [a, np.full((pad,) + a.shape[1:], fill, a.dtype)])

    codes_h = p2(arrays.codes, 4)
    lens_h = p2(arrays.mask.sum(axis=1).astype(np.uint16), 0)
    rgs = p2(arrays.rgs, 0)
    seconds = p2(arrays.seconds, False)

    # contiguous whole-batch slices; one background thread packs + puts
    # them in order so BOTH the 2-bit host pack and the transfer overlap
    # the caller's per-slice pass-1 dispatch (the pack alone costs
    # ~seconds of host time at scale — keep it off the critical path)
    sb = max(1, -(-nb // num_slices))          # batches per slice
    starts = list(range(0, nb, sb))
    import concurrent.futures as _cf
    # 3 pack workers: the per-slice 2-bit pack + sparse-N scan is
    # numpy-bound host work (~0.5 s total at bench scale) that otherwise
    # serializes ahead of the pass-1 dispatch loop; packs are
    # independent and results are consumed in submission order
    _put_ex = _cf.ThreadPoolExecutor(3)

    def _put_slice(b0):
        r0, r1 = b0 * B, min(nb, b0 + sb) * B
        ch = codes_h[r0:r1]
        ln = lens_h[r0:r1]
        # sparse N positions: only in-mask N bases need shipping (mask
        # re-marks tails and padding rows on device)
        in_mask = (np.arange(L, dtype=np.int32)[None, :]
                   < ln[:, None].astype(np.int32))
        n_pos = np.flatnonzero((ch == 4) & in_mask).astype(np.int32)
        return (jnp.asarray(_pack_quarters(ch)),
                jnp.asarray(n_pos),
                jnp.asarray(ln))

    slice_futs = [(_put_ex.submit(_put_slice, b0), b0) for b0 in starts]
    _put_ex.shutdown(wait=False)

    def staged_slices():
        """Yield (codes_i, mask_i, ids_i, wait_s) per slice, in order."""
        import time as _t
        for fut, b0 in slice_futs:
            t0 = _t.time()
            pk, npos, ln = fut.result()
            wait = _t.time() - t0
            yield _expand_inputs(pk, npos, ln,
                                 jnp.uint32(b0 * B), L=L,
                                 n_real=N) + (wait,)
    # quals are only read by the pass-3 ACCUMULATE (after the walks);
    # the pack+put starts NOW on a background thread and the caller
    # joins it only after the walk dispatch — the transfer hides under
    # the whole pass-1..3 compute window.  Real quality strings have FEW
    # distinct values (Illumina RTA3 emits exactly 4), so palette-pack:
    # ship 2-bit (<=4 distinct) or 4-bit (<=16) palette indices and
    # rebuild on device — 4x/2x fewer bytes for the dominant remaining
    # transfer; raw bytes only for >16 distinct values.  The pack itself
    # runs in the native codec off the GIL when available (the numpy
    # pack contends for the GIL with dispatches in flight).
    def _pack_and_put_quals(stage_times: dict):
        import time as _t

        from ..io import native_lib
        nonlocal quals_h
        quals_h = p2(arrays.quals, 0)
        t0 = _t.time()
        counts = native_lib.byte_hist(quals_h)
        if counts is None:
            # O(n) bincount/LUT palette detection (np.unique sorts — it
            # cost seconds of critical-path host time on 60 MB)
            counts = np.bincount(quals_h.ravel().view(np.uint8),
                                 minlength=256)
        uniq = np.flatnonzero(counts).astype(quals_h.dtype)
        qmode = 2 if uniq.size <= 4 else (4 if uniq.size <= 16 else 8)
        if qmode < 8:
            lut = np.zeros(256, np.uint8)
            lut[uniq.astype(np.uint8)] = np.arange(uniq.size,
                                                   dtype=np.uint8)
            packed_q = native_lib.pack_lut(quals_h, lut, qmode)
            if packed_q is None:                     # numpy fallback
                idx = lut[quals_h.view(np.uint8)]
                if qmode == 2:
                    packed_q = _pack_quarters(idx)
                else:
                    pad_c = (-idx.shape[1]) % 2
                    if pad_c:
                        idx = np.concatenate(
                            [idx, np.zeros((idx.shape[0], pad_c),
                                           np.uint8)], axis=1)
                    Lh = idx.shape[1] // 2
                    packed_q = idx[:, :Lh] | (idx[:, Lh:] << 4)
        else:
            packed_q = quals_h
        pal = np.pad(uniq, (0, (1 << qmode) - uniq.size)) \
            if qmode < 8 else uniq
        stage_times["pack"] = round(_t.time() - t0, 3)
        t1 = _t.time()
        dev = jax.device_put(packed_q)
        stage_times["put_call"] = round(_t.time() - t1, 3)
        return dev, pal, qmode

    quals_h = None                  # padded lazily: the resident driver
                                    # never ships quals (host accum)

    import time as _time
    _q_stages: dict = {}
    _q_state: list = []

    def start_quals():
        """Kick off the background quals pack+put (idempotent).  The
        resident driver no longer ships quals at all (host covariate
        accumulation over sparse error indices — ops/covariate_host.py),
        so the pack+put only runs for callers that ask."""
        if not _q_state:
            _qex = _cf.ThreadPoolExecutor(1)
            _q_state.append(_qex.submit(_pack_and_put_quals, _q_stages))
            _qex.shutdown(wait=False)

    def join_quals(timings=None):
        start_quals()
        dev, pal, qmode = _q_state[0].result()
        t0 = _time.time()
        out = _expand_quals(dev, jnp.asarray(pal), L=L,
                            qmode=qmode, dtype=quals_h.dtype.name)
        _q_stages["expand_call"] = round(_time.time() - t0, 3)
        if timings is not None:
            timings["quals_stages"] = dict(_q_stages)
        return out

    # rgs/seconds stay HOST arrays: the driver's covariate accumulation
    # and pass 4 both run on the host — putting them on device would
    # ship bytes nothing reads
    return staged_slices, join_quals, rgs, seconds, nb


@functools.partial(jax.jit, static_argnames=("L", "qmode", "dtype"))
def _expand_quals(packed, palette, *, L, qmode, dtype):
    """Device-side inverse of the palette pack in _pad_to_batches.

    Palette mapping is a chain of fused [N, L] compares (no table
    gather)."""
    if qmode == 8:
        return packed
    if qmode == 2:
        planes = [((packed >> s) & 3).astype(jnp.uint8)
                  for s in (0, 2, 4, 6)]
        idx = jnp.concatenate(planes, axis=1)[:, :L]
    else:
        idx = jnp.concatenate([packed & 15, packed >> 4], axis=1)[:, :L]
    out = jnp.zeros(idx.shape, palette.dtype)
    for i in range(1 << qmode):
        out = jnp.where(idx == i, palette[i], out)
    return out.astype(dtype)


@functools.partial(jax.jit, static_argnames=("k", "num_hashes", "B"),
                   donate_argnames=("slots",))
def _pass1_slice(slots, codes, ids, threshold, *, k, num_hashes, B):
    """Sampled-k-mer inserts for one staged slice (chained: the caller
    threads the donated staging `slots` through the slices as their
    transfers land, overlapping h2d with insert compute)."""
    nb = codes.shape[0] // B

    def body(carry, i):
        slots = carry
        c = jax.lax.dynamic_slice_in_dim(codes, i * B, B, 0)
        rid = jax.lax.dynamic_slice_in_dim(ids, i * B, B, 0)
        hi, lo, valid = canonical_kmers_batch(c, k)
        keep = valid & sample_keep_mask(rid, hi.shape[1], threshold)
        return bloom_insert_rows(slots, hi, lo, keep, num_hashes), None

    slots, _ = jax.lax.scan(body, slots, jnp.arange(nb))
    return slots


def _pass1_all(slots, codes, ids, threshold, *, k, num_hashes, B):
    """Single-dispatch pass 1 (kept for the AOT compile gate and
    non-sliced callers): slice inserts + row packing."""
    return bloom_rows(_pass1_slice(slots, codes, ids, threshold, k=k,
                                   num_hashes=num_hashes, B=B))


@functools.partial(jax.jit, static_argnames=("k", "num_hashes", "B"))
def _pass1_kmers_slice(codes, ids, threshold, *, k, num_hashes, B):
    """Per-slice k-mer HASH CACHE (h1, word, keep) for the DENSE pass-1
    build AND the pass-2/3 reuse: the compute overlaps the next slice's
    h2d like the scatter path, but inserts are deferred to one global
    sort (ops/bloom.py::bloom_rows_dense) instead of a serialized
    scatter per batch.

    h1 masks down to ANY filter's block index (blk = h1 &
    (2^(log2_m-5)-1)) and `word` (probe_word) depends only on h2 — so
    this single hash pass serves pass 1's sampled build, pass 2's
    filter-A query + filter-B build, and pass 3's initial all-window
    query, instead of recomputing the hash + probe word per pass.
    word == 0 marks invalid windows (probe_word is never zero on valid
    ones).

    Shapes: FLAT [rows * n]; consumers reshape per B-row slice."""
    nb = codes.shape[0] // B
    from ..ops.bloom import probe_word
    from ..ops.kmers import kmer_hashes

    def body(_, i):
        c = jax.lax.dynamic_slice_in_dim(codes, i * B, B, 0)
        rid = jax.lax.dynamic_slice_in_dim(ids, i * B, B, 0)
        hi, lo, valid = canonical_kmers_batch(c, k)
        keep = valid & sample_keep_mask(rid, hi.shape[1], threshold)
        h1, h2 = kmer_hashes(hi, lo)
        w = jnp.where(valid, probe_word(h2, num_hashes), jnp.uint32(0))
        return None, (h1.reshape(-1), w.reshape(-1), keep.reshape(-1))

    _, (h1s, ws, keeps) = jax.lax.scan(body, None, jnp.arange(nb))
    return h1s.reshape(-1), ws.reshape(-1), keeps.reshape(-1)


@functools.partial(jax.jit, static_argnames=("log2_m", "prefix"))
def _dense_finish(h1s, ws, keeps, *, log2_m, prefix=None):
    """Global dense build from the (h1, word, keep) hash cache; with
    `prefix` (pass 1: only ~alpha of slots are sampled) the post-sort
    stages run on the sampled prefix only — returns (rows, kept_count)
    and the CALLER must verify kept_count <= prefix (fall back to the
    unprefixed build otherwise)."""
    bmask = jnp.uint32((1 << (log2_m - 5)) - 1)
    cat = lambda xs: xs[0] if len(xs) == 1 else jnp.concatenate(xs)
    blk = cat(list(h1s)) & bmask
    w = cat(list(ws))
    keep = cat(list(keeps))
    if prefix is None:
        return bloom_rows_dense(blk, w, keep, log2_m)
    from ..ops.bloom import bloom_rows_dense_prefixed
    return bloom_rows_dense_prefixed(blk, w, keep, log2_m, prefix)


@functools.partial(jax.jit,
                   static_argnames=("k", "trust_threshold", "log2_m_a",
                                    "log2_m_b", "B", "n_win"))
def _pass2_dense_cached(rows_a, h1s, ws, t_table, *, k, trust_threshold,
                        log2_m_a, log2_m_b, B, n_win):
    """Dense-build pass 2 on the pass-1 hash cache: no re-hashing.
    The filter-A query is the all-probe-bits word test ((rows[blk] & w)
    == w — exactly bloom_query_rows' bit test, ops/bloom.py); trusted
    k-mers re-mask h1 to filter B's block index for the sort build.
    h1s/ws are the per-slice FLAT cache tuples — concatenated INSIDE
    the jit so the joined copy is transient, not a second resident
    footprint; each batch's [B*n_win] slice reshapes to [B, n_win]
    locally (n_win = windows per read)."""
    h1 = h1s[0] if len(h1s) == 1 else jnp.concatenate(h1s)
    w = ws[0] if len(ws) == 1 else jnp.concatenate(ws)
    mask_a = jnp.uint32((1 << (log2_m_a - 5)) - 1)
    mask_b = jnp.uint32((1 << (log2_m_b - 5)) - 1)
    bn = B * n_win
    nb = h1.shape[0] // bn

    def body(_, i):
        h1i = jax.lax.dynamic_slice_in_dim(h1, i * bn, bn, 0)\
            .reshape(B, n_win)
        wi = jax.lax.dynamic_slice_in_dim(w, i * bn, bn, 0)\
            .reshape(B, n_win)
        valid = wi != 0
        hits = ((rows_a[(h1i & mask_a).astype(jnp.int32)] & wi) == wi) \
            & valid
        tr = trusted_mask_batch(hits, valid, t_table, k, trust_threshold)
        return None, ((h1i & mask_b).reshape(-1), wi.reshape(-1),
                      tr.reshape(-1))

    _, (blks, wso, trs) = jax.lax.scan(body, None, jnp.arange(nb))
    return bloom_rows_dense(blks.reshape(-1), wso.reshape(-1),
                            trs.reshape(-1), log2_m_b)


@functools.partial(jax.jit,
                   static_argnames=("k", "num_hashes", "trust_threshold",
                                    "log2_m", "B"))
def _pass2_dense(rows_a, codes, t_table, *, k, num_hashes,
                 trust_threshold, log2_m, B):
    """Dense-build pass 2: the trusted test stays a per-batch scan (it
    queries filter A), but trusted k-mers accumulate as (block, word)
    pairs and ONE sort builds filter B — no insert scatter."""
    nb = codes.shape[0] // B

    def body(_, i):
        c = jax.lax.dynamic_slice_in_dim(codes, i * B, B, 0)
        hi, lo, valid = canonical_kmers_batch(c, k)
        hits = bloom_query_rows(rows_a, hi, lo, num_hashes) & valid
        tr = trusted_mask_batch(hits, valid, t_table, k, trust_threshold)
        blk, w = probe_words(hi, lo, num_hashes, log2_m)
        return None, (blk.reshape(-1), w.reshape(-1), tr.reshape(-1))

    _, (blks, ws, trs) = jax.lax.scan(body, None, jnp.arange(nb))
    return bloom_rows_dense(blks.reshape(-1), ws.reshape(-1),
                            trs.reshape(-1), log2_m)


@functools.partial(jax.jit,
                   static_argnames=("k", "num_hashes", "trust_threshold",
                                    "B"),
                   donate_argnames=("slots_b",))
def _pass2_all(rows_a, slots_b, codes, t_table, *, k, num_hashes,
               trust_threshold, B):
    nb = codes.shape[0] // B

    def body(carry, i):
        slots_b = carry
        c = jax.lax.dynamic_slice_in_dim(codes, i * B, B, 0)
        hi, lo, valid = canonical_kmers_batch(c, k)
        hits = bloom_query_rows(rows_a, hi, lo, num_hashes) & valid
        tr = trusted_mask_batch(hits, valid, t_table, k, trust_threshold)
        return bloom_insert_rows(slots_b, hi, lo, tr, num_hashes), None

    slots_b, _ = jax.lax.scan(body, slots_b, jnp.arange(nb))
    return bloom_rows(slots_b)


@functools.partial(jax.jit,
                   static_argnames=("k", "num_hashes", "ext_cap",
                                    "B", "walk_chunk", "log2_m_b"))
def _pass3_walks(rows_b, codes, h1=None, w=None, *, k, num_hashes,
                 ext_cap, B, walk_chunk=WALK_CHUNK, log2_m_b=0):
    """Error inference for every batch: bool [N, L].  The walks need
    only codes, so callers dispatch them before any quals work.

    With the pass-1 hash cache (h1, w — see _pass1_kmers_slice), each
    batch's initial all-window trust query runs as the cached word test
    against filter B instead of re-hashing the batch's k-mers."""
    nb = codes.shape[0] // B

    n_win = codes.shape[1] - k + 1

    def body(_, i):
        c = jax.lax.dynamic_slice_in_dim(codes, i * B, B, 0)
        if h1 is None:
            tr = valid = None
        else:
            bn = B * n_win
            h1i = jax.lax.dynamic_slice_in_dim(h1, i * bn, bn, 0)\
                .reshape(B, n_win)
            wi = jax.lax.dynamic_slice_in_dim(w, i * bn, bn, 0)\
                .reshape(B, n_win)
            valid = wi != 0
            mask_b = jnp.uint32((1 << (log2_m_b - 5)) - 1)
            tr = ((rows_b[(h1i & mask_b).astype(jnp.int32)] & wi) == wi) \
                & valid
        # walk_chunk-wide walks, difficulty-scheduled, walk body
        # compiled once (lax.map inside)
        errors = infer_errors(rows_b, c, k, num_hashes,
                              walk_chunk=walk_chunk, ext_cap=ext_cap,
                              trusted0=tr, valid0=valid)
        return None, errors

    _, errors = jax.lax.scan(body, None, jnp.arange(nb))
    return errors.reshape(codes.shape)


@jax.jit
def _pack_error_bits(errors):
    """Bit-pack the walk's [N, L] bool error mask for the d2h hop.

    Errors are sparse (~0.5-2% of bases) but the mask is dense; packed
    bits are 8x fewer bytes than bools and need no dynamic-shape
    compaction on device (the host flatnonzero is
    trivial).  numpy-compatible big bit order."""
    return jnp.packbits(errors.reshape(-1))


# sparse errbit d2h capacity, as a fraction of slice bases (1/denom).
# Bench-like data marks ~0.5-1% of bases as errors; 1/64 (1.56%) keeps
# the sparse path active with margin while still halving the dense
# transfer (cap*4 B vs n/8 B).  Module-level so tests can force the
# dense fallback.
SPARSE_ERR_DENOM = 64
_SPARSE_ERR_MIN = 1024


def sparse_err_cap(local_n: int) -> int:
    """Sparse error-index capacity for a flat base count — the shared
    policy for the single-chip slices and the sharded per-shard
    transport (parallel/resident_sharded.py calls this too)."""
    return min(local_n, max(_SPARSE_ERR_MIN, local_n // SPARSE_ERR_DENOM))


@functools.partial(jax.jit, static_argnames=("cap",))
def _sparse_error_idx(errors, *, cap):
    """(count, idx[cap]) sparse encoding of the error mask for d2h.

    Sorted flat indices of the set bits are exact and 2x smaller than
    the dense bit-packed mask at the 1/64 capacity.  Compaction is one
    int32 sort.  count > cap means the encoding is invalid and the
    CALLER must re-fetch the dense bits.
    """
    flat = errors.reshape(-1)
    n = flat.shape[0]
    iota = jax.lax.iota(jnp.int32, n)
    keys = jnp.where(flat, iota, jnp.int32(n))
    ks = jax.lax.sort(keys)
    cnt = jnp.sum(flat.astype(jnp.int32))
    # one array, count at [0]: one d2h per slice instead of two
    return jnp.concatenate([cnt[None], ks[:cap]])


@functools.partial(jax.jit,
                   static_argnames=("B", "num_rg", "max_len"))
def _pass3_accum(errors, codes, quals, mask, rgs, seconds, *, B, num_rg,
                 max_len):
    nb = codes.shape[0] // B
    cov0 = new_covariate_state(num_rg, max_len)

    def body(cov, i):
        sl = lambda a: jax.lax.dynamic_slice_in_dim(a, i * B, B, 0)
        cov = accumulate_covariates(cov, sl(codes), sl(quals), sl(mask),
                                    sl(rgs), sl(seconds), sl(errors))
        return cov, None

    cov, _ = jax.lax.scan(body, cov0, jnp.arange(nb))
    return cov


@functools.partial(jax.jit, static_argnames=("B",))
def _pass4_all(recal, codes, quals, mask, rgs, seconds, *, B):
    nb = codes.shape[0] // B

    def body(_, i):
        sl = lambda a: jax.lax.dynamic_slice_in_dim(a, i * B, B, 0)
        nq = apply_recal_table(recal, sl(codes), sl(quals), sl(mask),
                               sl(rgs), sl(seconds))
        return None, nq

    _, out = jax.lax.scan(body, None, jnp.arange(nb))
    return out.reshape(codes.shape)


def recalibrate_arrays_resident(arrays: ReadArrays, config: RecalConfig,
                                timings: dict | None = None) -> np.ndarray:
    """Full pipeline, one dispatch per pass.  Bit-identical to
    recalibrate_arrays (tests assert it).  If `timings` is given, per-pass
    wall times (s) are recorded into it (passes block at boundaries)."""
    import time as _time
    t_last = [_time.time()]

    def _mark(name):
        if timings is not None:
            now = _time.time()
            timings[name] = round(now - t_last[0], 3)
            t_last[0] = now

    k, h = config.k, config.num_hashes
    B = config.batch_size

    # staging threads first: the per-slice 2-bit packs + puts run in the
    # background while the host computes thresholds/filter params below
    staged_slices, join_quals, rgs, seconds, nb = \
        _pad_to_batches(arrays, B)

    lens = arrays.mask.sum(axis=1)
    total_bases = int(lens.sum())
    total_kmers = int(np.maximum(lens - k + 1, 0).sum())
    num_rg = int(arrays.rgs.max(initial=0)) + 1
    alpha, coverage = config.resolve_alpha(total_bases)
    threshold = jnp.uint32(alpha_threshold(alpha))
    t_table = jnp.asarray(coverage_thresholds(alpha, k), dtype=jnp.int32)
    from ..oracle.pipeline import bloom_params_for
    params_a, params_b = bloom_params_for(config, total_kmers, alpha,
                                          coverage)
    _mark("setup")

    # DENSE sort-builds replace the insert scatters when the whole
    # dataset's k-mer triples fit a device budget (~9 B/k-mer); the
    # streaming scatter path remains for anything larger
    n_kmer_slots = nb * ((arrays.max_len - k + 1) if arrays.max_len >= k
                         else 0) * B
    dense = 0 < n_kmer_slots * 9 <= device_budget("dense_build")
    from ..oracle.bloom import check_layout_capacity
    for p in (params_a, params_b):
        # dense builds hold only packed rows (m/8 bytes); the scatter
        # fallback stages a byte per slot
        check_layout_capacity(
            p, 33 if dense else 31, "single-chip resident",
            "use the streaming driver or --devices N "
            "--bloom-layout sharded")

    # h2d/pass-1 overlap: as each codes slice lands, chain its sampled
    # k-mer compute (dense) or inserts (scatter path) — transfer of
    # slice i+1 overlaps slice i's compute
    slots = None if dense else jnp.zeros(params_a.m, jnp.uint8)
    la = int(params_a.m).bit_length() - 1
    lb = int(params_b.m).bit_length() - 1
    codes_parts, mask_parts, kmer_parts = [], [], []
    slice_times = []
    for codes_i, mask_i, ids_i, wait in staged_slices():
        codes_parts.append(codes_i)
        mask_parts.append(mask_i)
        t_d = _time.time()
        if dense:
            kmer_parts.append(_pass1_kmers_slice(
                codes_i, ids_i, threshold, k=k, num_hashes=h, B=B))
        else:
            slots = _pass1_slice(slots, codes_i, ids_i, threshold,
                                 k=k, num_hashes=h, B=B)
        slice_times.append((round(wait, 2),
                            round(_time.time() - t_d, 2)))
    codes = (codes_parts[0] if len(codes_parts) == 1
             else jnp.concatenate(codes_parts, axis=0))
    mask = (mask_parts[0] if len(mask_parts) == 1
            else jnp.concatenate(mask_parts, axis=0))
    if timings is not None:
        # (transfer-future wait, pass1 dispatch time) per staged slice —
        # attributes staging-loop stalls between transfer and dispatch
        timings["h2d_slices"] = slice_times
    _mark("h2d")

    if dense:
        parts = (tuple(p[0] for p in kmer_parts),
                 tuple(p[1] for p in kmer_parts),
                 tuple(p[2] for p in kmer_parts))
        Ns = sum(p[0].shape[0] for p in kmer_parts)
        P = min(Ns, int(Ns * alpha * SAMPLE_PREFIX_SLACK)
                + _SAMPLE_PREFIX_PAD)
        rows_a, cnt = _dense_finish(*parts, log2_m=la, prefix=P)
    else:
        rows_a, cnt, P = bloom_rows(slots), None, 0
    jax.block_until_ready(rows_a)  # pass-boundary sync: per-pass times
    _mark("pass1")
    # sampled-prefix overflow check (adversarial input only): the count
    # is read AFTER the pass-1 block — a mid-chain int() d2h would stall
    # the build — and on overflow the filter is rebuilt unprefixed (same
    # bits, slower)
    if cnt is not None and int(cnt) > P:
        rows_a = _dense_finish(*parts, log2_m=la)
        jax.block_until_ready(rows_a)
    # hash-cache reuse toggle (KBBQ_HASH_CACHE=0 restores the
    # recompute-per-pass path for A/B sweeps)
    import os as _os
    hash_cache = dense and \
        _os.environ.get("KBBQ_HASH_CACHE", "1") == "1"
    if hash_cache:
        # the pass-1 hash cache (h1, word) answers pass 2's filter-A
        # query + filter-B build AND pass 3's initial trust query
        # without re-hashing (the keep planes free here)
        h1_parts = tuple(p[0] for p in kmer_parts)
        w_parts = tuple(p[1] for p in kmer_parts)
        kmer_parts = parts = None       # free the keep planes
        rows_b = _pass2_dense_cached(
            rows_a, h1_parts, w_parts, t_table, k=k,
            trust_threshold=config.trust_threshold, log2_m_a=la,
            log2_m_b=lb, B=B,
            n_win=max(arrays.max_len - k + 1, 0))
    elif dense:
        kmer_parts = parts = None
        rows_b = _pass2_dense(rows_a, codes, t_table, k=k, num_hashes=h,
                              trust_threshold=config.trust_threshold,
                              log2_m=lb, B=B)
    else:
        rows_b = _pass2_all(rows_a, jnp.zeros(params_b.m, jnp.uint8),
                            codes, t_table, k=k, num_hashes=h,
                            trust_threshold=config.trust_threshold, B=B)
    jax.block_until_ready(rows_b)
    _mark("pass2")
    # walks are codes-only; quals never go to the device at all.  The
    # covariate histogram runs on the HOST (ops/covariate_host.py): the
    # walk's error mask comes back as sparse indices (bit-packed when
    # dense), and the threaded C++ accumulator counts over the quals
    # that already live in host RAM.
    #
    # Walks dispatch PER STAGED SLICE: slice i's errors come back and
    # histogram on a worker thread while slice i+1's walks run on
    # device, so the d2h + host accumulation hide under walk compute
    # instead of following it.  One worker thread keeps the
    # (commutative-integer) accumulation in order into a single table —
    # bit-identical under any split.
    N = arrays.num_reads
    L = arrays.max_len
    from ..oracle.covariate import CovariateTables
    from ..ops.covariate_host import accumulate_covariates_host
    tables = CovariateTables(num_rg, L)
    fetch_waits: list = []

    def _fetch_accum(enc_dev, bits_g, r0: int, rows: int):
        t0 = _time.time()
        enc = np.asarray(enc_dev)         # blocks until the slice's walks
        cnt = int(enc[0])
        cap = enc.shape[0] - 1
        if cnt <= cap:
            err_idx = enc[1:1 + cnt].astype(np.int64)
        else:
            # error-dense slice (adversarial input): the sparse encoding
            # overflowed its capacity — fetch the exact dense bits
            bits = np.asarray(bits_g)
            err_idx = np.flatnonzero(
                np.unpackbits(bits, count=rows * L)).astype(np.int64)
        fetch_waits.append(round(_time.time() - t0, 3))
        r1 = min(r0 + rows, N)
        if r1 <= r0:
            return
        err_idx = err_idx[err_idx < (r1 - r0) * L]
        accumulate_covariates_host(
            arrays.codes[r0:r1], arrays.quals[r0:r1], arrays.mask[r0:r1],
            arrays.rgs[r0:r1], arrays.seconds[r0:r1], err_idx, num_rg, L,
            tables=tables)

    import concurrent.futures as _cf2
    _acc_ex = _cf2.ThreadPoolExecutor(1)
    acc_futs = []
    r0 = 0
    wc = config.walk_chunk or WALK_CHUNK
    for pi, part in enumerate(codes_parts):
        if hash_cache:
            err_g = _pass3_walks(rows_b, part, h1_parts[pi], w_parts[pi],
                                 k=k, num_hashes=h,
                                 ext_cap=config.ext_cap, B=B,
                                 walk_chunk=wc, log2_m_b=lb)
        else:
            err_g = _pass3_walks(rows_b, part, k=k, num_hashes=h,
                                 ext_cap=config.ext_cap, B=B,
                                 walk_chunk=wc)
        n_flat = part.shape[0] * L
        enc_g = _sparse_error_idx(err_g, cap=sparse_err_cap(n_flat))
        # pack the dense fallback bits eagerly and hand the FUTURE only
        # the packed view: the queued work then retains n/8 bytes per
        # in-flight slice instead of the full [rows, L] bool mask
        # (8x; ADVICE.md round 2) — err_g itself frees at loop end
        bits_g = _pack_error_bits(err_g)
        acc_futs.append(_acc_ex.submit(
            _fetch_accum, enc_g, bits_g, r0, part.shape[0]))
        r0 += part.shape[0]
    for f in acc_futs:
        f.result()
    _acc_ex.shutdown(wait=False)
    if timings is not None:
        timings["errbit_waits"] = fetch_waits
    _mark("pass3")

    recal = build_recal_table(tables)
    _mark("deltas")

    # pass 4 on HOST: a pure integer gather over the tiny recal table,
    # bit-identical to the device kernel (ops/recal.py twin) — the quals
    # already live in host RAM, so nothing [N, L]-sized crosses the bus
    res = apply_recal_table_host(recal, arrays.codes, arrays.quals,
                                 arrays.mask, arrays.rgs, arrays.seconds)
    _mark("pass4")
    return res
