"""Pure JAX kernels — the device compute path (SURVEY.md §8.1 L1).

Every op here is bit-exact against its twin in ``kbbq_tpu.oracle`` (tests/
test_ops.py): all device arithmetic is integer-only (uint32/int32), so
results are invariant to sharding, fusion and batch order (SURVEY.md H5).
"""

from .kmers import (
    fmix32,
    canonical_kmers_batch,
    kmer_hashes,
    sample_keep_mask,
)
from .bloom import (
    bloom_insert,
    bloom_query,
    bloom_query_rows,
    bloom_rows,
    probe_positions,
)
from .trusted import coverage_counts, trusted_mask_batch
from .inference import infer_errors_batch
from .covariate import accumulate_covariates, new_covariate_state
from .recal import apply_recal_table
