"""Covariate accumulation state: int32 device epochs -> int64 host totals.

Device tables accumulate int32 (no x64 mode needed) within an epoch
whose event count is provably < 2^31, then fold into host int64 totals
(exact — integer adds commute; SURVEY.md H5).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..oracle.covariate import CovariateTables
from ..ops.covariate import new_covariate_state

_FLUSH_KEYS = ("cyc_total", "cyc_errors", "din_total", "din_errors")


def _flatten_state(state: dict):
    """One flat i32 vector for a single device->host transfer.

    Concatenating on device makes the flush one transfer instead of
    four.
    Lazily jitted (module import must not touch a backend).
    """
    import jax.numpy as jnp
    return jnp.concatenate([state[k].reshape(-1) for k in _FLUSH_KEYS])


@dataclasses.dataclass
class CovariateAccumulator:
    num_rg: int
    max_len: int
    batch_events: int           # worst-case events per batch (B * Lmax)
    totals: CovariateTables = None
    device_state: dict = None
    _epoch_batches: int = 0

    def __post_init__(self):
        if self.totals is None:
            self.totals = CovariateTables(self.num_rg, self.max_len)
        if self.device_state is None:
            self.device_state = new_covariate_state(self.num_rg, self.max_len)
        # worst case: every event lands in one cell
        self.flush_every = max(1, (2**31 - 1) // max(1, self.batch_events))

    def note_batch(self) -> None:
        self._epoch_batches += 1
        if self._epoch_batches >= self.flush_every:
            self.flush()

    def flush(self) -> None:
        if self._epoch_batches == 0:
            return
        # plain asarray then astype: one bulk transfer, widened on host
        flat = np.asarray(_flatten_state(self.device_state)) \
            .astype(np.int64)
        off = 0
        s = {}
        for k in _FLUSH_KEYS:
            sh = self.device_state[k].shape
            n = int(np.prod(sh))
            s[k] = flat[off:off + n].reshape(sh)
            off += n
        self.totals.cyc_total += s["cyc_total"]
        self.totals.cyc_errors += s["cyc_errors"]
        self.totals.din_total += s["din_total"]
        self.totals.din_errors += s["din_errors"]
        self.device_state = new_covariate_state(self.num_rg, self.max_len)
        self._epoch_batches = 0
