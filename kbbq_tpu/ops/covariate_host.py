"""Host-side pass-3 covariate accumulation over sparse error indices.

Twin of ops/covariate.py::accumulate_covariates (itself the batch twin of
oracle/covariate.py::accumulate_read).  Feeding the device histogram
means shipping the [N, L] reported-quality array host->device, the
largest transfer of the resident pipeline.  Errors, by contrast, are
SPARSE (~0.5-2% of bases), so the cheap direction is the
other way: compact the walk's [N, L] error mask to flat indices on
device, ship ~1-2 MB device->host, and histogram on the host where the
quals already live.  All counts are integer +1 adds — bit-identical to
the device one-hot histogram under any order/threading (SURVEY.md H5).

The C++ kernel (io/native/kbbq_io.cc::kbbq_accum_cov) runs threaded and
off the GIL; the NumPy twin below is the fallback and the test oracle.
"""

from __future__ import annotations

import numpy as np

from ..constants import MIN_USABLE_Q, NUM_DINUC, NUM_Q
from ..oracle.covariate import CovariateTables


def _accumulate_numpy(codes, quals, mask, rgs, seconds, err_idx,
                      tables: CovariateTables) -> None:
    """Vectorized NumPy twin of kbbq_accum_cov (adds into `tables`)."""
    N, L = codes.shape
    codes = codes.astype(np.int32)
    quals = quals.astype(np.int32)
    err = np.zeros(N * L, dtype=bool)
    err[err_idx] = True
    err = err.reshape(N, L)

    use = mask.astype(bool) & (codes != 4) & (quals >= MIN_USABLE_Q)
    q = np.clip(quals, 0, NUM_Q - 1)
    i = np.arange(L, dtype=np.int32)[None, :]
    cyc = i * 2 + seconds.astype(np.int32)[:, None]
    prev = np.concatenate(
        [np.full((N, 1), 4, np.int32), codes[:, :-1]], axis=1)
    din_ok = use & (prev != 4) & (codes != 4) & (i > 0)
    din = prev * 4 + codes

    rgq = rgs.astype(np.int64)[:, None] * NUM_Q + q
    nc = tables.cyc_total.shape[2]
    flat_cyc = (rgq * nc + cyc)[use]
    np.add.at(tables.cyc_total.reshape(-1), flat_cyc, 1)
    np.add.at(tables.cyc_errors.reshape(-1), (rgq * nc + cyc)[use & err], 1)
    flat_din = (rgq * NUM_DINUC + din)[din_ok]
    np.add.at(tables.din_total.reshape(-1), flat_din, 1)
    np.add.at(tables.din_errors.reshape(-1),
              (rgq * NUM_DINUC + din)[din_ok & err], 1)


def accumulate_covariates_host(codes, quals, mask, rgs, seconds, err_idx,
                               num_rg: int, max_len: int,
                               tables: CovariateTables | None = None
                               ) -> CovariateTables:
    """Accumulate a whole dataset's covariate counts on the host.

    codes/quals int8 [N, L]; mask bool [N, L]; rgs int32 [N]; seconds
    bool [N]; err_idx: sorted flat indices (i*L + j) of walk-marked
    bases.  Returns int64 CovariateTables (new, or `tables` added to).
    """
    if tables is None:
        tables = CovariateTables(num_rg, max_len)
    from ..io import native_lib
    if not native_lib.accum_cov(codes, quals, mask, rgs, seconds,
                                err_idx, tables, MIN_USABLE_Q):
        _accumulate_numpy(np.asarray(codes), np.asarray(quals),
                          np.asarray(mask), np.asarray(rgs),
                          np.asarray(seconds),
                          np.asarray(err_idx, dtype=np.int64), tables)
    return tables
