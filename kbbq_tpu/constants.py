"""Shared exact-arithmetic constants for kbbq-tpu.

Everything here is part of the *bit-exact* spec shared by the NumPy oracle
(``kbbq_tpu.oracle``) and the JAX kernels (``kbbq_tpu.ops``).  Any change
here changes the output bytes; see ``kbbq_tpu/oracle/DECISIONS.md``.

Parity note: the reference (adamjorr/kbbq) mount was empty at build time
(SURVEY.md §0), so these constants define OUR canonical semantics; they are
designed to be recalibrated against the real tool if it ever appears
(SURVEY.md Appendix C).
"""

# ---------------------------------------------------------------------------
# Base encoding (SURVEY.md Appendix A.1)
# ---------------------------------------------------------------------------
# 2-bit code: A=0, C=1, G=2, T=3.  Complement(code) = 3 - code.
# Any other character (N, lowercase handled by upper-casing in IO) -> BASE_N.
BASE_A, BASE_C, BASE_G, BASE_T = 0, 1, 2, 3
BASE_N = 4  # sentinel for invalid base; kept in int8 seq arrays

# Phred offset for FASTQ quality characters.
PHRED_OFFSET = 33

# ---------------------------------------------------------------------------
# K-mer layer (Appendix A.1)
# ---------------------------------------------------------------------------
DEFAULT_K = 32          # k <= 32 (2 bits/base packed into two uint32 lanes)
MAX_K = 32

# ---------------------------------------------------------------------------
# Hashing (32-bit only — part of the bit-exact spec; SURVEY.md H3)
# ---------------------------------------------------------------------------
# murmur3 fmix32 constants
FMIX32_C1 = 0x85EBCA6B
FMIX32_C2 = 0xC2B2AE35
# domain-separation seeds (arbitrary but fixed; part of the spec)
HASH_SEED_H1 = 0x9E3779B9      # bloom probe base
HASH_SEED_H2 = 0x85EBCA77      # bloom probe stride
HASH_SEED_SAMPLE = 0xC0FFEE01  # pass-1 subsampling decision

# ---------------------------------------------------------------------------
# Bloom filters (Appendix A.2; layout discussion SURVEY.md §7/H4)
# ---------------------------------------------------------------------------
# Byte-per-slot layout (uint8 0/1).  Rationale: every random probe costs one
# HBM cache line regardless of bit- vs byte-packing, so bytes cost no extra
# bandwidth, make insert a plain scatter-set (no read-modify-write) and query
# a plain gather.  Capacity is the only cost; human-scale filters shard
# across chips (kbbq_tpu.parallel).
DEFAULT_SAMPLED_BITS_PER_KEY = 20   # filter A sized for ~0.1% FPR
DEFAULT_TRUSTED_BITS_PER_KEY = 20   # filter B
DEFAULT_NUM_HASHES = 7              # probes per key (double hashing)
MIN_BLOOM_LOG2 = 16                 # never smaller than 64 Ki slots
# Addressing ceiling of the blocked layout: the 32-bit block hash h1
# selects one of 2^(log2_m-5) blocks, and device scatter/gather indices
# are int32 words, so blocks must number < 2^31 -> log2_m <= 36
# (2^36 slots = 8 GB packed).  Human 30x WGS trusted k-mers (~2.5e9
# distinct at 20 bits/key ~ 2^35.6 slots) fit; sizing beyond 2^36
# raises BloomCapacityError (lower bits/key or shard more).
MAX_BLOOM_LOG2 = 36

# ---------------------------------------------------------------------------
# Sampling (Appendix A.1): deterministic hash-threshold subsampling.
# keep(kmer) iff sample_hash(kmer) < floor(alpha * 2^32).
# Deterministic => reproducible and shard-count invariant (SURVEY.md H1).
# ---------------------------------------------------------------------------
LIGHTER_ALPHA_NUMERATOR = 7.0  # default alpha = 7 / coverage (Lighter rec.)

# Pass-2 coverage rule (DECISIONS.md D6): base covered iff the number of
# A-positive overlapping k-mers s satisfies s >= t(x), with t(x) the 1%%
# upper tail cutoff of Binom(x, alpha).
P_FALSE_COVER = 0.01

# ---------------------------------------------------------------------------
# Covariate model (Appendix A.3)
# ---------------------------------------------------------------------------
MAX_Q = 93            # reported/empirical qualities live in 0..93
NUM_Q = MAX_Q + 1     # 94
MIN_USABLE_Q = 6      # bases with reported q < 6 are skipped (GATK convention)
RECAL_MIN_Q = 1       # recalibrated q clamped to [RECAL_MIN_Q, MAX_Q]
NUM_DINUC = 16        # (prev, cur) 2-bit pairs; index = prev*4 + cur
DINUC_INVALID = 16    # first base of read / N-adjacent (delta contribution 0)
PRIOR_SIGMA = 0.5     # std-dev of the Gaussian prior over (Qemp - prior)

# Cycle encoding: read1 cycle = +(i+1), read2 cycle = -(i+1) (machine order).
# Table index: idx = (|c| - 1) * 2 + (1 if c < 0 else 0)  in [0, 2*max_len).
def cycle_to_index(cycle):
    """Works on python ints, numpy arrays and jnp arrays."""
    neg = cycle < 0
    mag = abs(cycle)
    return (mag - 1) * 2 + neg

DEFAULT_MAX_READ_LEN = 160  # static padded read length for device batches

# D7: substitution-trial extensions are measured over at most EXT_CAP
# consecutive windows.  The reference extends to k, and since round 3
# that IS the default: with the skip-run walk engine the extra probe
# traffic costs only ~7% of bench wall (pass3 1.53s -> 1.80s at 400k
# reads, docs/PERF.md round-3 table), so reference semantics win over
# the round-1 W=8 economy (whose discount was priced when probes were
# 4x the walk cost).  W=8 remains available via --ext-cap 8.
DEFAULT_EXT_CAP = 32
