"""Every main-path jit lowers at production shapes to portable StableHLO.

The device path is plain jax.numpy/lax: lowering each pass program at
the E. coli run's shapes (B=8192, L=150, k=32, 2^28-slot filters) must
succeed on any backend and emit no TPU custom call or Mosaic kernel.
Lowering only traces — nothing is allocated at these sizes.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

B, L, K, H = 8192, 150, 32, 7
N = 2 * B                       # two batches per scanned program
LOG2_M = 28
M = 1 << LOG2_M
NWIN = L - K + 1


def _s(shape, dtype):
    return jax.ShapeDtypeStruct(shape, dtype)


CODES = _s((N, L), jnp.int8)
QUALS = _s((N, L), jnp.int8)
MASK = _s((N, L), jnp.bool_)
RGS = _s((N,), jnp.int32)
SECS = _s((N,), jnp.bool_)
IDS = _s((N,), jnp.uint32)
ROWS = _s((M // 32,), jnp.uint32)
SLOTS = _s((M,), jnp.uint8)
THR = _s((), jnp.uint32)
TTAB = _s((K + 1,), jnp.int32)
FLAT = _s((N * NWIN,), jnp.uint32)
FLATB = _s((N * NWIN,), jnp.bool_)
QRY = _s((B, NWIN), jnp.uint32)


def _cases():
    from kbbq_tpu.ops import bloom
    from kbbq_tpu.ops.covariate import accumulate_covariates, \
        new_covariate_state
    from kbbq_tpu.ops.inference import infer_errors_batch, \
        infer_errors_scheduled
    from kbbq_tpu.ops.recal import apply_recal_table
    from kbbq_tpu.pipeline import resident as r

    recal = _s((1, 94, 2 * L, 17), jnp.int8)
    return {
        "bloom_query_rows": (
            lambda p, a, b: bloom.bloom_query_rows(p, a, b, H),
            (ROWS, QRY, QRY)),
        "bloom_insert_rows": (
            lambda s, a, b, m: bloom.bloom_insert_rows(s, a, b, m, H),
            (SLOTS, QRY, QRY, _s((B, NWIN), jnp.bool_))),
        "bloom_rows": (bloom.bloom_rows, (SLOTS,)),
        "infer_errors_batch": (
            functools.partial(infer_errors_batch, k=K, num_hashes=H),
            (ROWS, _s((512, L), jnp.int8))),
        "infer_errors_scheduled": (
            functools.partial(infer_errors_scheduled, k=K, num_hashes=H,
                              chunk=512),
            (ROWS, _s((B, L), jnp.int8))),
        "accumulate_covariates": (
            lambda c, q, m, g, s, e: accumulate_covariates(
                new_covariate_state(1, L), c, q, m, g, s, e),
            (_s((B, L), jnp.int8), _s((B, L), jnp.int8),
             _s((B, L), jnp.bool_), _s((B,), jnp.int32),
             _s((B,), jnp.bool_), _s((B, L), jnp.bool_))),
        "apply_recal_table": (
            apply_recal_table,
            (recal, _s((B, L), jnp.int8), _s((B, L), jnp.int8),
             _s((B, L), jnp.bool_), _s((B,), jnp.int32),
             _s((B,), jnp.bool_))),
        "resident_pass1_slice": (
            functools.partial(r._pass1_slice.__wrapped__, k=K,
                              num_hashes=H, B=B),
            (SLOTS, CODES, IDS, THR)),
        "resident_pass1_kmers_slice": (
            functools.partial(r._pass1_kmers_slice.__wrapped__, k=K,
                              num_hashes=H, B=B),
            (CODES, IDS, THR)),
        "resident_dense_finish": (
            lambda a, b, c: r._dense_finish.__wrapped__(
                (a,), (b,), (c,), log2_m=LOG2_M, prefix=N * NWIN // 4),
            (FLAT, FLAT, FLATB)),
        "resident_pass2_dense_cached": (
            lambda rows, a, b, t: r._pass2_dense_cached.__wrapped__(
                rows, (a,), (b,), t, k=K, trust_threshold=None,
                log2_m_a=LOG2_M, log2_m_b=LOG2_M, B=B, n_win=NWIN),
            (ROWS, FLAT, FLAT, TTAB)),
        "resident_pass2_all": (
            functools.partial(r._pass2_all.__wrapped__, k=K,
                              num_hashes=H, trust_threshold=None, B=B),
            (ROWS, SLOTS, CODES, TTAB)),
        "resident_pass3_walks_cached": (
            functools.partial(r._pass3_walks.__wrapped__, k=K,
                              num_hashes=H, ext_cap=None, B=B,
                              walk_chunk=512, log2_m_b=LOG2_M),
            (ROWS, CODES, FLAT, FLAT)),
        "resident_pass3_accum": (
            functools.partial(r._pass3_accum.__wrapped__, B=B, num_rg=1,
                              max_len=L),
            (MASK, CODES, QUALS, MASK, RGS, SECS)),
        "resident_pass4_all": (
            functools.partial(r._pass4_all.__wrapped__, B=B),
            (recal, CODES, QUALS, MASK, RGS, SECS)),
    }


CASES = sorted(_cases())


@pytest.mark.parametrize("name", CASES)
def test_main_path_lowers_without_tpu_ops(name):
    fn, avals = _cases()[name]
    text = jax.jit(fn).lower(*avals).as_text()
    assert "stablehlo" in text or "mhlo" in text
    lowered = text.lower()
    assert "tpu_custom_call" not in lowered
    assert "mosaic" not in lowered


@pytest.mark.parametrize("dtype", [np.int8, np.bool_])
def test_permute_rows_mxu_equals_take(dtype):
    """The walk's one-hot matmul permutation is a row gather, exactly."""
    from kbbq_tpu.ops.inference import _permute_rows_mxu

    rng = np.random.default_rng(3)
    R, C = 96, 40
    if dtype is np.bool_:
        x = rng.random((R, C)) < 0.3
    else:
        x = rng.integers(-128, 128, size=(R, C)).astype(np.int8)
    order = jnp.asarray(rng.permutation(R).astype(np.int32))
    onehot = (jnp.arange(R, dtype=jnp.int32)[None, :]
              == order[:, None]).astype(jnp.bfloat16)
    xj = jnp.asarray(x)
    got = np.asarray(_permute_rows_mxu(onehot, xj))
    want = np.asarray(jnp.take(xj, order, axis=0))
    assert got.dtype == want.dtype
    assert np.array_equal(got, want)
    # and the inverse permutation (transpose) restores the input
    back = np.asarray(_permute_rows_mxu(onehot.T, jnp.asarray(got)))
    assert np.array_equal(back, x)
