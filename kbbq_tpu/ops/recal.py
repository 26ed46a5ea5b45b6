"""Pass-4 JAX kernel: recalibrated quality assignment (D10).

"The final per-base recalibrated quality assignment is a pure gather over
the merged empirical-quality tables" (BASELINE.json north star): all float
delta math happens on host in float64 (oracle/gatk.py), producing a dense
int8 table Q'[rg, q, cycle_idx, dinuc(17)]; the device does one integer
gather per base.  Twin: oracle/pipeline.py pass 4.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .covariate import base_covariates

_i32 = jnp.int32


def apply_recal_table_host(recal, codes, quals, mask, rgs, seconds,
                           chunk: int = 65536):
    """NumPy twin of apply_recal_table, bit-identical by construction.

    Pass 4 is a pure integer gather over the tiny recal table; running it
    on the HOST lets the resident pipeline skip the [N, L] recalibrated-
    quality device->host transfer entirely (the table is ~1000x smaller
    than the output it generates).  All ops are integer, so host/device
    agreement is exact; tests/test_resident.py pins it.
    """
    import os
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from ..constants import DINUC_INVALID, MIN_USABLE_Q, NUM_Q
    from ..io import native_lib

    trace = bool(os.environ.get("KBBQ_P4_TRACE"))
    import time as _t
    t0 = _t.time()
    r_h = np.asarray(recal)
    t1 = _t.time()
    res = native_lib.apply_recal(r_h, codes, quals, mask, rgs,
                                 seconds, MIN_USABLE_Q, DINUC_INVALID)
    if trace:
        import sys
        print(f"[p4] recal d2h/as-np {t1 - t0:.3f}s native "
              f"{_t.time() - t1:.3f}s", file=sys.stderr, flush=True)
    if res is not None:
        return res

    from ..utils.mem import hugepage_empty
    N, L = codes.shape
    out = hugepage_empty((N, L), np.int8)
    i32 = np.int32
    pos = np.arange(L, dtype=i32)[None, :]
    recal_flat = np.ascontiguousarray(recal).reshape(-1)
    nrg, nq, nc, nd = recal.shape

    def work(s):
        e = min(N, s + chunk)
        c = codes[s:e].astype(i32)
        q0 = quals[s:e].astype(i32)
        skip = (~mask[s:e]) | (c == 4) | (q0 < MIN_USABLE_Q)
        q = np.clip(q0, 0, NUM_Q - 1)
        cyc = pos * 2 + seconds[s:e, None].astype(i32)
        prev = np.concatenate(
            [np.full((e - s, 1), 4, i32), c[:, :-1]], axis=1)
        din_ok = (prev != 4) & (c != 4) & (pos > 0)
        din = np.where(din_ok, prev * 4 + c, DINUC_INVALID)
        rg = rgs[s:e].astype(i32)[:, None]
        flat = ((rg * nq + q) * nc + cyc) * nd + din
        res = recal_flat[flat]
        out[s:e] = np.where(skip, q0, res).astype(np.int8)

    starts = range(0, N, chunk)
    # big numpy ufuncs release the GIL; chunks are disjoint so threaded
    # writes into `out` are race-free and the result is bit-identical to
    # the sequential loop
    with ThreadPoolExecutor(min(os.cpu_count() or 1, 8)) as ex:
        list(ex.map(work, starts))
    return out


@jax.jit
def apply_recal_table(recal: jax.Array, codes: jax.Array, quals: jax.Array,
                      mask: jax.Array, rgs: jax.Array,
                      seconds: jax.Array) -> jax.Array:
    """New per-base qualities: int8 [B, L].

    recal: int8 [num_rg, NUM_Q, 2*max_len, 17]; skipped bases keep their
    original reported quality.
    """
    cv = base_covariates(codes, quals, mask, seconds)
    rg = rgs.astype(_i32)[:, None]
    din = cv["din"]  # DINUC_INVALID (=16) indexes the zero-delta column
    # one flattened-index gather per base, fenced so the gather does not
    # swallow the index math / output select
    nrg, nq, nc, nd = recal.shape
    flat = ((rg * nq + cv["q"]) * nc + cv["cyc"]) * nd + din
    flat = jax.lax.optimization_barrier(flat)
    out = recal.reshape(-1)[flat]
    out = jax.lax.optimization_barrier(out)
    return jnp.where(cv["skip"], quals, out).astype(jnp.int8)
