"""Pass-3 JAX kernel: covariate scatter-add accumulation (D8).

Twin: oracle/covariate.py::accumulate_read.  Counters are int32 on device
(a flush cycle caps events per device epoch well below 2^31; the pipeline
folds epochs into host int64 totals — exact, with no x64 mode on
device).  Scatter-adds of +1 commute, so any sharding/batch order yields
identical tables (SURVEY.md H5).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..constants import (
    DINUC_INVALID,
    MIN_USABLE_Q,
    NUM_DINUC,
    NUM_Q,
)

_i32 = jnp.int32


def new_covariate_state(num_rg: int, max_len: int):
    """Zeroed device tables: dict of int32 arrays."""
    nc = 2 * max_len
    z = functools.partial(jnp.zeros, dtype=_i32)
    return {
        "cyc_total": z((num_rg, NUM_Q, nc)),
        "cyc_errors": z((num_rg, NUM_Q, nc)),
        "din_total": z((num_rg, NUM_Q, NUM_DINUC)),
        "din_errors": z((num_rg, NUM_Q, NUM_DINUC)),
    }


def base_covariates(codes: jax.Array, quals: jax.Array, mask: jax.Array,
                    seconds: jax.Array):
    """Per-base covariate indices for a batch.

    Args:
      codes: int8 [B, L]; quals: int8 [B, L]; mask: bool [B, L] real-base;
      seconds: bool [B] second-in-pair.
    Returns dict: skip [B,L] bool, q [B,L] i32, cyc [B,L] i32, din [B,L] i32.
    """
    B, L = codes.shape
    codes = codes.astype(_i32)
    quals = quals.astype(_i32)
    skip = (~mask) | (codes == 4) | (quals < MIN_USABLE_Q)
    q = jnp.clip(quals, 0, NUM_Q - 1)

    i = jax.lax.broadcasted_iota(_i32, (B, L), 1)
    cyc1 = i * 2            # (i+1-1)*2, read-1 lanes
    cyc2 = i * 2 + 1        # (i+1-1)*2+1, read-2 lanes
    cyc = jnp.where(seconds[:, None], cyc2, cyc1)

    prev = jnp.concatenate(
        [jnp.full((B, 1), 4, dtype=_i32), codes[:, :-1]], axis=1)
    din_ok = (prev != 4) & (codes != 4)
    din_ok = din_ok & (i > 0)
    din = jnp.where(din_ok, prev * 4 + codes, DINUC_INVALID)
    return {"skip": skip, "q": q, "cyc": cyc, "din": din}


@jax.jit
def accumulate_covariates(state: dict, codes: jax.Array, quals: jax.Array,
                          mask: jax.Array, rgs: jax.Array,
                          seconds: jax.Array, errors: jax.Array) -> dict:
    """Accumulate one batch into the covariate tables via one-hot int8
    matmuls (the north star's "one-hot scatter-adds", literally): the
    histograms are int8 x int8 -> int32 contractions instead of
    scatter-adds:

      cyc[rgq, cyc_idx] += sum_b onehot_rgq[b, l]         (cycle ~ l)
      din[rgq, dinuc]   += onehot_rgq[B*L, :]^T @ onehot_din[B*L, :]

    int32 sums of 0/1 are exact and commutative — bit-identical to the
    scatter version under any order/sharding (SURVEY.md H5).  state is
    donated by the pipeline's jit wrapper.
    """
    B, L = codes.shape
    cv = base_covariates(codes, quals, mask, seconds)
    use = ~cv["skip"]
    err = errors & use
    rg = rgs.astype(_i32)[:, None]

    nc = state["cyc_total"].shape[2]
    num_rg = state["cyc_total"].shape[0]
    nrgq = num_rg * NUM_Q

    rgq = rg * NUM_Q + cv["q"]                         # [B, L]
    bins = jax.lax.broadcasted_iota(_i32, (1, 1, nrgq), 2)
    oh_rgq = (rgq[:, :, None] == bins).astype(jnp.int8)  # [B, L, nrgq]
    use8 = use.astype(jnp.int8)
    err8 = err.astype(jnp.int8)

    # ---- cycle tables: cycle index is a function of (l, second) ----
    # split lanes by read-2 flag so each group has one cycle per column
    def cyc_hist(weight8):
        # [L, nrgq] per second-flag value; contraction over B
        w1 = weight8 * (~seconds)[:, None].astype(jnp.int8)
        w2 = weight8 * seconds[:, None].astype(jnp.int8)
        h1 = jnp.einsum("bl,blq->lq", w1, oh_rgq,
                        preferred_element_type=_i32)
        h2 = jnp.einsum("bl,blq->lq", w2, oh_rgq,
                        preferred_element_type=_i32)
        # scatter the L columns to their cycle indices: read1 col l ->
        # 2l, read2 col l -> 2l+1 -- a static interleave, no gather
        out = jnp.zeros((nc, nrgq), dtype=_i32)
        out = out.at[0:2 * L:2].add(h1)
        out = out.at[1:2 * L:2].add(h2)
        return out.T.reshape(num_rg, NUM_Q, nc)

    cyc_total = state["cyc_total"] + cyc_hist(use8)
    cyc_errors = state["cyc_errors"] + cyc_hist(err8)

    # ---- dinuc tables: [BL, nrgq]^T @ [BL, NUM_DINUC] ----
    din_ok = use & (cv["din"] != DINUC_INVALID)
    dbins = jax.lax.broadcasted_iota(_i32, (1, 1, NUM_DINUC), 2)
    oh_din = (cv["din"][:, :, None] == dbins).astype(jnp.int8)
    flat_rgq = oh_rgq.reshape(B * L, nrgq)

    def din_hist(weight):
        w = (oh_din * weight[:, :, None].astype(jnp.int8)) \
            .reshape(B * L, NUM_DINUC)
        return jnp.einsum("nq,nd->qd", flat_rgq, w,
                          preferred_element_type=_i32) \
            .reshape(num_rg, NUM_Q, NUM_DINUC)

    din_total = state["din_total"] + din_hist(din_ok)
    din_errors = state["din_errors"] + din_hist(err & din_ok)

    return {
        "cyc_total": cyc_total,
        "cyc_errors": cyc_errors,
        "din_total": din_total,
        "din_errors": din_errors,
    }
