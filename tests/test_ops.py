"""Bit-exactness tests: every JAX kernel vs its NumPy-oracle twin.

Run on CPU (conftest forces JAX_PLATFORMS=cpu, 8 virtual devices); all ops
are integer-only so CPU and GPU agree exactly.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from kbbq_tpu.constants import DEFAULT_NUM_HASHES
from kbbq_tpu.io.batcher import ReadArrays
from kbbq_tpu.oracle import BloomParams, CovariateTables, OracleBloom
from kbbq_tpu.oracle import accumulate_read
from kbbq_tpu.oracle import kmers as okm
from kbbq_tpu.oracle import lighter as olight
from kbbq_tpu.oracle.covariate import compute_skips, cycle_indices, dinuc_indices
from kbbq_tpu.oracle.gatk import build_recal_table
from kbbq_tpu.ops import (
    accumulate_covariates,
    apply_recal_table,
    bloom_insert,
    bloom_query,
    bloom_query_rows,
    bloom_rows,
    canonical_kmers_batch,
    fmix32,
    infer_errors_batch,
    new_covariate_state,
    sample_keep_mask,
    trusted_mask_batch,
)
from kbbq_tpu.ops import kmers as jkm
from kbbq_tpu.utils.synth import make_dataset


def _random_codes(rng, B, L, n_rate=0.02, short_rate=0.3):
    """Batch with pads (short reads) and Ns, plus per-read lists."""
    codes = np.full((B, L), 4, dtype=np.int8)
    lists = []
    for b in range(B):
        m = L if rng.random() > short_rate else int(rng.integers(1, L + 1))
        row = rng.integers(0, 4, size=m).astype(np.int8)
        row[rng.random(m) < n_rate] = 4
        codes[b, :m] = row
        lists.append(row)
    return codes, lists


def test_fmix32_matches_oracle():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 2**32, size=1000, dtype=np.uint32)
    assert (np.asarray(fmix32(jnp.asarray(x))) == okm.fmix32(x)).all()


@pytest.mark.parametrize("k", [4, 16, 17, 31, 32])
def test_canonical_kmers_batch_matches_oracle(k):
    rng = np.random.default_rng(k)
    B, L = 16, 50
    codes, lists = _random_codes(rng, B, L)
    hi, lo, valid = canonical_kmers_batch(jnp.asarray(codes), k)
    hi, lo, valid = map(np.asarray, (hi, lo, valid))
    for b in range(B):
        ohi, olo, ovalid = okm.canonical_kmers(codes[b], k)
        n = L - k + 1
        assert (valid[b] == np.pad(ovalid, (0, n - ovalid.size))).all()
        sel = valid[b][:ovalid.size] & ovalid
        assert (hi[b][:ovalid.size][sel] == ohi[sel]).all()
        assert (lo[b][:ovalid.size][sel] == olo[sel]).all()


def test_kmer_hashes_match_oracle():
    rng = np.random.default_rng(1)
    hi = rng.integers(0, 2**32, size=500, dtype=np.uint32)
    lo = rng.integers(0, 2**32, size=500, dtype=np.uint32)
    jh1, jh2 = jkm.kmer_hashes(jnp.asarray(hi), jnp.asarray(lo))
    oh1, oh2 = okm.kmer_hashes(hi, lo)
    assert (np.asarray(jh1) == oh1).all()
    assert (np.asarray(jh2) == oh2).all()


def test_sample_keep_mask_matches_oracle():
    rng = np.random.default_rng(2)
    B, n = 64, 40
    rids = rng.integers(0, 2**32, size=B, dtype=np.uint32)
    thresh = okm.alpha_threshold(0.3)
    got = np.asarray(sample_keep_mask(jnp.asarray(rids), n, thresh))
    offs = np.arange(n, dtype=np.uint32)
    for b in range(B):
        want = okm.sample_hash(rids[b], offs) <= thresh
        assert (got[b] == want).all()


def test_bloom_roundtrip_matches_oracle():
    rng = np.random.default_rng(3)
    params = BloomParams.for_keys(5000, 20)
    ob = OracleBloom(params)
    hi = rng.integers(0, 2**32, size=5000, dtype=np.uint32)
    lo = rng.integers(0, 2**32, size=5000, dtype=np.uint32)
    mask = rng.random(5000) < 0.5
    ob.insert(hi, lo, mask=mask)

    slots = jnp.zeros(params.m, dtype=jnp.uint8)
    slots = bloom_insert(slots, jnp.asarray(hi), jnp.asarray(lo),
                         jnp.asarray(mask), params.num_hashes)
    assert (np.asarray(slots) == ob.slots).all()

    qhi = rng.integers(0, 2**32, size=3000, dtype=np.uint32)
    qlo = rng.integers(0, 2**32, size=3000, dtype=np.uint32)
    got = np.asarray(bloom_query(slots, jnp.asarray(qhi), jnp.asarray(qlo),
                                 params.num_hashes))
    assert (got == ob.query(qhi, qlo)).all()
    # uint32 row view query must agree with byte-level query exactly
    rows = bloom_rows(slots)
    got_r = np.asarray(bloom_query_rows(rows, jnp.asarray(qhi),
                                        jnp.asarray(qlo),
                                        params.num_hashes))
    assert (got_r == got).all()


def test_blocked_bloom_fpr_under_one_percent():
    rng = np.random.default_rng(9)
    n_keys = 50_000
    params = BloomParams.for_keys(n_keys, 20)
    ob = OracleBloom(params)
    hi = rng.integers(0, 2**32, size=n_keys, dtype=np.uint32)
    lo = rng.integers(0, 2**32, size=n_keys, dtype=np.uint32)
    ob.insert(hi, lo)
    qhi = rng.integers(0, 2**32, size=100_000, dtype=np.uint32)
    qlo = rng.integers(0, 2**32, size=100_000, dtype=np.uint32)
    fpr = ob.query(qhi, qlo).mean()
    assert fpr < 0.01, f"blocked-bloom FPR {fpr}"


def _build_filters(ds, k, alpha):
    """Oracle pass-1 + pass-2 filters for a synthetic dataset."""
    thresh = okm.alpha_threshold(alpha)
    a = OracleBloom(BloomParams.for_keys(50_000, 20))
    for rid, codes in enumerate(ds.codes):
        hi, lo, valid = okm.canonical_kmers(codes, k)
        offs = np.arange(hi.size, dtype=np.uint32)
        keep = valid & (okm.sample_hash(np.uint32(rid), offs) <= thresh)
        a.insert(hi, lo, mask=keep)
    b = OracleBloom(BloomParams.for_keys(50_000, 20))
    for codes in ds.codes:
        tr = olight.trusted_kmer_mask(codes, k, a, alpha)
        if tr.any():
            hi, lo, _ = okm.canonical_kmers(codes, k)
            b.insert(hi, lo, mask=tr)
    return a, b


def test_trusted_mask_matches_oracle():
    k, alpha = 16, 7.0 / 30.0
    ds = make_dataset(genome_len=2000, read_len=60, coverage=30.0,
                      error_rate=0.02, seed=11, n_rate=0.01)
    bloom_a, _ = _build_filters(ds, k, alpha)
    arrays = ReadArrays.from_lists(ds.codes, ds.quals, ds.rgs, ds.seconds)
    codes_j = jnp.asarray(arrays.codes)
    hi, lo, valid = canonical_kmers_batch(codes_j, k)
    hits = bloom_query(jnp.asarray(bloom_a.slots), hi, lo,
                       bloom_a.params.num_hashes) & valid
    t_table = jnp.asarray(olight.coverage_thresholds(alpha, k))
    got = np.asarray(trusted_mask_batch(hits, valid, t_table, k))
    for i, codes in enumerate(ds.codes[:50]):
        want = olight.trusted_kmer_mask(codes, k, bloom_a, alpha)
        n = want.size
        assert (got[i][:n] == want).all(), f"read {i}"
        assert not got[i][n:].any()


def test_infer_errors_matches_oracle():
    k, alpha = 16, 7.0 / 30.0
    ds = make_dataset(genome_len=2000, read_len=60, coverage=30.0,
                      error_rate=0.03, seed=13, n_rate=0.01)
    _, bloom_b = _build_filters(ds, k, alpha)
    arrays = ReadArrays.from_lists(ds.codes, ds.quals, ds.rgs, ds.seconds)
    rows = bloom_rows(jnp.asarray(bloom_b.slots))
    got = np.asarray(infer_errors_batch(
        rows, jnp.asarray(arrays.codes), k, bloom_b.params.num_hashes))
    mismatches = []
    for i, codes in enumerate(ds.codes[:120]):
        want = olight.infer_read_errors(codes, k, bloom_b)
        if not (got[i][:want.size] == want).all():
            mismatches.append(i)
    assert not mismatches, f"reads disagree: {mismatches[:10]}"


def test_infer_errors_chunked_matches_plain():
    from kbbq_tpu.ops.inference import infer_errors_chunked
    k, alpha = 16, 7.0 / 30.0
    ds = make_dataset(genome_len=1500, read_len=60, coverage=30.0,
                      error_rate=0.03, seed=23, n_rate=0.01)
    _, bloom_b = _build_filters(ds, k, alpha)
    arrays = ReadArrays.from_lists(ds.codes, ds.quals, ds.rgs, ds.seconds)
    rows = bloom_rows(jnp.asarray(bloom_b.slots))
    codes = jnp.asarray(arrays.codes)
    plain = np.asarray(infer_errors_batch(rows, codes, k, 7))
    chunked = np.asarray(infer_errors_chunked(rows, codes, k, 7, chunk=32))
    assert (plain == chunked).all()
    # scheduled variant (lax.map walks + one-hot matmul permutation):
    # must be bit-identical too (needs a chunk-divisible batch)
    from kbbq_tpu.ops.inference import infer_errors, infer_errors_scheduled
    B = (codes.shape[0] // 32) * 32
    sch = np.asarray(infer_errors_scheduled(rows, codes[:B], k, 7,
                                            chunk=32))
    assert (plain[:B] == sch).all()
    # the production router must agree on both its routes
    routed = np.asarray(infer_errors(rows, codes[:B], k, 7, walk_chunk=32))
    assert (plain[:B] == routed).all()
    routed2 = np.asarray(infer_errors(rows, codes, k, 7, walk_chunk=None))
    assert (plain == routed2).all()
    # empty-filter corner: no anchors anywhere -> nothing marked
    empty = jnp.zeros_like(rows)
    got = np.asarray(infer_errors_batch(empty, codes, k, 7))
    assert not got.any()


def test_infer_errors_scheduled_skip_run_engine():
    """The hard-tail skip-run engine must be bit-identical.

    Adversarial shape that forces it: reads with a trusted anchor
    followed by a long junk tail — every tail window is an active,
    non-committing break (candidates fail), so the lane's untrusted
    count saturates past the hard threshold and the chunk routes to
    the speculative engine (ops/inference.py::_walk_rounds skip_cols).
    Mixed with clean and lightly-errored reads so both fori loops run.
    """
    from kbbq_tpu.ops.inference import infer_errors_scheduled
    k = 16
    rng = np.random.default_rng(77)
    genome = rng.integers(0, 4, size=4000).astype(np.int8)
    L = 80
    B = 64
    reads = []
    for i in range(B):
        s = int(rng.integers(0, genome.size - L))
        r = genome[s:s + L].copy()
        kind = i % 4
        if kind == 1:      # junk tail: anchor k-mers + random right half
            r[L // 2:] = rng.integers(0, 4, size=L - L // 2)
        elif kind == 2:    # junk head: left half random
            r[:L // 2] = rng.integers(0, 4, size=L // 2)
        elif kind == 3:    # sparse real errors (committing breaks)
            for p in rng.integers(k, L - 1, size=2):
                r[p] = (r[p] + 1) % 4
        reads.append(r)
    codes = np.stack(reads)
    # trusted filter = every genome k-mer (all anchor windows commitable)
    b = OracleBloom(BloomParams.for_keys(genome.size, 20))
    hi, lo, valid = okm.canonical_kmers(genome, k)
    b.insert(hi, lo, mask=valid)
    rows = bloom_rows(jnp.asarray(b.slots))
    codes_j = jnp.asarray(codes)
    h = b.params.num_hashes
    plain = np.asarray(infer_errors_batch(rows, codes_j, k, h))
    sch = np.asarray(infer_errors_scheduled(rows, codes_j, k, h, chunk=16))
    assert (plain == sch).all()
    # oracle agreement on the junk-heavy reads too
    for i in range(B):
        want = olight.infer_read_errors(codes[i], k, b)
        assert (plain[i][:want.size] == want).all(), f"read {i}"


def test_infer_errors_edge_shapes():
    """Pads, reads < k, all-N reads: no errors marked, no crashes."""
    k = 16
    bloom_b = OracleBloom(BloomParams.for_keys(1000, 20))
    codes = np.full((4, 40), 4, dtype=np.int8)
    codes[0, :10] = 1          # shorter than k
    codes[1, :] = 2            # uniform read, empty filter
    # codes[2]: all N; codes[3]: all pad
    got = np.asarray(infer_errors_batch(
        bloom_rows(jnp.asarray(bloom_b.slots)), jnp.asarray(codes), k,
        bloom_b.params.num_hashes))
    assert not got.any()


def test_accumulate_covariates_matches_oracle():
    ds = make_dataset(genome_len=1500, read_len=50, coverage=10.0,
                      error_rate=0.02, seed=17, num_rg=3, paired=True,
                      n_rate=0.02)
    arrays = ReadArrays.from_lists(ds.codes, ds.quals, ds.rgs, ds.seconds)
    rng = np.random.default_rng(5)
    errors = rng.random(arrays.codes.shape) < 0.05
    errors &= arrays.mask

    state = new_covariate_state(3, arrays.max_len)
    state = accumulate_covariates(
        state, jnp.asarray(arrays.codes), jnp.asarray(arrays.quals),
        jnp.asarray(arrays.mask), jnp.asarray(arrays.rgs),
        jnp.asarray(arrays.seconds), jnp.asarray(errors))

    tables = CovariateTables(3, arrays.max_len)
    for i in range(len(ds.codes)):
        L = len(ds.codes[i])
        accumulate_read(tables, ds.codes[i], ds.quals[i], errors[i][:L],
                        ds.rgs[i], ds.seconds[i])
    assert (np.asarray(state["cyc_total"]) == tables.cyc_total).all()
    assert (np.asarray(state["cyc_errors"]) == tables.cyc_errors).all()
    assert (np.asarray(state["din_total"]) == tables.din_total).all()
    assert (np.asarray(state["din_errors"]) == tables.din_errors).all()


def test_apply_recal_table_matches_oracle():
    ds = make_dataset(genome_len=1500, read_len=50, coverage=10.0,
                      error_rate=0.02, seed=19, num_rg=2, paired=True)
    arrays = ReadArrays.from_lists(ds.codes, ds.quals, ds.rgs, ds.seconds)
    tables = CovariateTables(2, arrays.max_len)
    rng = np.random.default_rng(7)
    for i in range(len(ds.codes)):
        L = len(ds.codes[i])
        err = rng.random(L) < 0.03
        accumulate_read(tables, ds.codes[i], ds.quals[i], err,
                        ds.rgs[i], ds.seconds[i])
    recal = build_recal_table(tables)

    got = np.asarray(apply_recal_table(
        jnp.asarray(recal), jnp.asarray(arrays.codes),
        jnp.asarray(arrays.quals), jnp.asarray(arrays.mask),
        jnp.asarray(arrays.rgs), jnp.asarray(arrays.seconds)))

    for i in range(len(ds.codes)):
        codes = np.asarray(ds.codes[i], dtype=np.int64)
        quals = np.asarray(ds.quals[i], dtype=np.int64)
        L = len(codes)
        skips = compute_skips(codes, quals)
        q = np.clip(quals, 0, NUM_Q_MAX)
        cyc = cycle_indices(L, ds.seconds[i])
        din = dinuc_indices(codes)
        want = recal[ds.rgs[i], q, cyc, din].astype(np.int64)
        want = np.where(skips, quals, want)
        assert (got[i][:L] == want).all(), f"read {i}"


NUM_Q_MAX = 93


def test_bloom_rows_dense_matches_scatter():
    """The sort-based dense filter build (ops/bloom.py::bloom_rows_dense)
    must produce the exact packed words of the scatter insert path."""
    import jax.numpy as jnp

    from kbbq_tpu.ops.bloom import (bloom_insert_rows, bloom_rows,
                                    bloom_rows_dense, probe_words)

    rng = np.random.default_rng(5)
    m, h = 1 << 16, 7
    N = 4096
    hi = jnp.asarray(rng.integers(0, 2**32, N, dtype=np.uint32))
    lo = jnp.asarray(rng.integers(0, 2**32, N, dtype=np.uint32))
    mask = jnp.asarray(rng.random(N) < 0.8)
    log2_m = m.bit_length() - 1
    slots = bloom_insert_rows(jnp.zeros(m, jnp.uint8), hi, lo, mask, h)
    want = np.asarray(bloom_rows(slots))
    blk, w = probe_words(hi, lo, h, log2_m)
    got = np.asarray(bloom_rows_dense(blk, w, mask, log2_m))
    assert (got == want).all()
    # all-masked corner: empty filter
    none = np.asarray(bloom_rows_dense(blk, w, jnp.zeros(N, bool),
                                       log2_m))
    assert not none.any()


def test_accumulate_covariates_host_matches_device():
    """Host covariate accumulation (C++ kernel + NumPy twin) is
    bit-identical to the device one-hot histogram given the same sparse
    error indices (integer adds commute — SURVEY.md H5)."""
    from kbbq_tpu.constants import MIN_USABLE_Q
    from kbbq_tpu.io.native_lib import accum_cov
    from kbbq_tpu.ops.covariate_host import (_accumulate_numpy,
                                             accumulate_covariates_host)

    ds = make_dataset(genome_len=1500, read_len=50, coverage=10.0,
                      error_rate=0.02, seed=23, num_rg=3, paired=True,
                      n_rate=0.02)
    arrays = ReadArrays.from_lists(ds.codes, ds.quals, ds.rgs, ds.seconds)
    rng = np.random.default_rng(11)
    errors = (rng.random(arrays.codes.shape) < 0.05) & arrays.mask
    err_idx = np.flatnonzero(errors.reshape(-1)).astype(np.int64)

    from kbbq_tpu.ops.covariate import (accumulate_covariates,
                                        new_covariate_state)
    state = new_covariate_state(3, arrays.max_len)
    state = accumulate_covariates(
        state, jnp.asarray(arrays.codes), jnp.asarray(arrays.quals),
        jnp.asarray(arrays.mask), jnp.asarray(arrays.rgs),
        jnp.asarray(arrays.seconds), jnp.asarray(errors))

    got = accumulate_covariates_host(
        arrays.codes, arrays.quals, arrays.mask, arrays.rgs,
        arrays.seconds, err_idx, 3, arrays.max_len)
    # NumPy twin separately (the entry point may have taken the C++ path)
    tw = CovariateTables(3, arrays.max_len)
    _accumulate_numpy(arrays.codes, arrays.quals, arrays.mask,
                      arrays.rgs, arrays.seconds, err_idx, tw)
    for name in ("cyc_total", "cyc_errors", "din_total", "din_errors"):
        dev = np.asarray(state[name])
        assert (getattr(got, name) == dev).all(), name
        assert (getattr(tw, name) == dev).all(), f"numpy twin {name}"
    # and the C++ kernel explicitly, when the native lib is present
    cc = CovariateTables(3, arrays.max_len)
    if accum_cov(arrays.codes, arrays.quals, arrays.mask, arrays.rgs,
                 arrays.seconds, err_idx, cc, MIN_USABLE_Q):
        for name in ("cyc_total", "cyc_errors", "din_total",
                     "din_errors"):
            assert (getattr(cc, name) == np.asarray(state[name])).all(), \
                f"native {name}"
