"""Sharded pass steps: shard_map over the reads axis.

Layout (SURVEY.md §3.3 table):

- batch arrays [B, L]: sharded on axis 0 (reads axis), B % D == 0 (the
  batcher always emits full fixed-size batches).
- Bloom filters during an INSERT pass: [D, m] — one replica per device,
  each device scatter-sets only its read shard; replicas are merged once
  at the pass boundary with an all-reduce max (scatter-set commutes, so
  the merged filter is bit-identical to the single-chip one).
- Bloom filters during a QUERY pass: [m] replicated (read-only gathers).
- covariate tables: [D, ...] per-device partials, summed at flush
  (integer adds commute -> shard-count invariant, SURVEY.md H5).

Sampling keys on global read ordinals carried in the batch, so the sampled
set is independent of D by construction (DECISIONS.md D5).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Iterable

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..io.batcher import Batch, Batcher, ReadArrays
from ..oracle.bloom import BloomParams
from ..oracle.gatk import build_recal_table
from ..oracle.kmers import alpha_threshold
from ..oracle.lighter import coverage_thresholds
from ..ops.bloom import bloom_insert_rows, bloom_query_rows, \
    bloom_rows
from ..ops.covariate import accumulate_covariates, new_covariate_state
from ..ops.inference import infer_errors
from ..ops.kmers import canonical_kmers_batch, sample_keep_mask
from ..ops.recal import apply_recal_table
from ..ops.trusted import trusted_mask_batch
from ..pipeline.recalibrate import RecalConfig
from ..state.covariate import CovariateAccumulator
from .mesh import READS_AXIS, make_mesh

R = READS_AXIS


def _shmap(mesh, in_specs, out_specs):
    return functools.partial(jax.shard_map, mesh=mesh, in_specs=in_specs,
                             out_specs=out_specs, check_vma=False)


def build_sharded_steps(mesh: Mesh, k: int, num_hashes: int,
                        trust_threshold: int | None = None,
                        ext_cap: int | None = None):
    """jitted sharded step functions bound to a mesh."""

    @functools.partial(jax.jit, static_argnames=(), donate_argnums=(0,))
    @_shmap(mesh,
            in_specs=(P(R, None), P(R, None), P(R), P()),
            out_specs=P(R, None))
    def step_sample(slots_dm, codes, read_ids, threshold):
        hi, lo, valid = canonical_kmers_batch(codes, k)
        keep = valid & sample_keep_mask(read_ids, hi.shape[1], threshold)
        return bloom_insert_rows(slots_dm[0], hi, lo, keep, num_hashes)[None]

    @functools.partial(jax.jit, donate_argnums=(1,))
    @_shmap(mesh,
            in_specs=(P(None), P(R, None), P(R, None), P()),
            out_specs=P(R, None))
    def step_trusted(rows_a, slots_b_dm, codes, t_table):
        hi, lo, valid = canonical_kmers_batch(codes, k)
        hits = bloom_query_rows(rows_a, hi, lo, num_hashes) & valid
        tr = trusted_mask_batch(hits, valid, t_table, k, trust_threshold)
        return bloom_insert_rows(slots_b_dm[0], hi, lo, tr, num_hashes)[None]

    @functools.partial(jax.jit, donate_argnums=(1,))
    @_shmap(mesh,
            in_specs=(P(None), {k_: P(R, *([None] * 3)) for k_ in
                            ("cyc_total", "cyc_errors",
                             "din_total", "din_errors")},
                      P(R, None), P(R, None), P(R, None), P(R), P(R)),
            out_specs={k_: P(R, *([None] * 3)) for k_ in
                       ("cyc_total", "cyc_errors",
                        "din_total", "din_errors")})
    def step_covariates(rows_b, cov_dm, codes, quals, mask, rgs, seconds):
        # production walk router (difficulty-scheduled when the local
        # batch divides into walk chunks)
        errors = infer_errors(rows_b, codes, k, num_hashes,
                              ext_cap=ext_cap)
        local = {kk: v[0] for kk, v in cov_dm.items()}
        out = accumulate_covariates(local, codes, quals, mask, rgs,
                                    seconds, errors)
        return {kk: v[None] for kk, v in out.items()}

    @jax.jit
    @_shmap(mesh,
            in_specs=(P(), P(R, None), P(R, None), P(R, None), P(R), P(R)),
            out_specs=P(R, None))
    def step_recal(recal, codes, quals, mask, rgs, seconds):
        return apply_recal_table(recal, codes, quals, mask, rgs, seconds)

    @jax.jit
    def merge_bloom(slots_dm):
        # all-reduce max over the replica axis -> replicated uint32 row
        # view [R, 8] for the query passes
        merged = jnp.max(slots_dm, axis=0)
        packed = bloom_rows(merged)
        return jax.lax.with_sharding_constraint(
            packed, NamedSharding(mesh, P(None)))

    return {
        "sample": step_sample,
        "trusted": step_trusted,
        "covariates": step_covariates,
        "recal": step_recal,
        "merge_bloom": merge_bloom,
    }


class ShardedRecalPipeline:
    """P1-P4 over a 1-D mesh; bit-identical to the single-chip pipeline."""

    def __init__(self, config: RecalConfig, num_rg: int, max_len: int,
                 total_bases: int, total_kmers: int, mesh: Mesh | None = None):
        self.mesh = mesh or make_mesh()
        self.D = self.mesh.devices.size
        if config.batch_size % self.D:
            raise ValueError(
                f"batch_size {config.batch_size} not divisible by "
                f"{self.D} devices")
        self.config = config
        self.num_rg = num_rg
        self.max_len = max_len
        self.alpha, self.coverage = config.resolve_alpha(total_bases)
        self.threshold = jnp.uint32(alpha_threshold(self.alpha))
        self.t_table = self._replicate(jnp.asarray(
            coverage_thresholds(self.alpha, config.k), dtype=jnp.int32))
        from ..oracle.bloom import check_layout_capacity
        from ..oracle.pipeline import bloom_params_for
        self.params_a, self.params_b = bloom_params_for(
            config, total_kmers, self.alpha, self.coverage)
        for p in (self.params_a, self.params_b):
            # replicated byte staging per chip: 2^31 slots = 2 GiB each
            check_layout_capacity(p, 31, "replicated",
                                  "use --bloom-layout sharded")
        self.steps = build_sharded_steps(self.mesh, config.k,
                                         config.num_hashes,
                                         config.trust_threshold,
                                         config.ext_cap)
        self.cov = CovariateAccumulator(
            num_rg, max_len, config.batch_size * max_len)
        # device covariate state is [D, ...] sharded on the replica axis
        self.cov_dm = self._dev_tables()
        self.bloom_a_merged = None
        self.bloom_b_merged = None
        self.recal_table = None

    # ----------------------------------------------------------- helpers
    def _replicate(self, x):
        return jax.device_put(x, NamedSharding(self.mesh, P()))

    def _shard_rows(self, x):
        spec = P(R, *([None] * (x.ndim - 1)))
        return jax.device_put(jnp.asarray(x), NamedSharding(self.mesh, spec))

    def _dev_tables(self):
        base = new_covariate_state(self.num_rg, self.max_len)
        return {kk: self._shard_rows(
            jnp.zeros((self.D,) + v.shape, v.dtype))
            for kk, v in base.items()}

    def _empty_replicas(self, params: BloomParams):
        return self._shard_rows(
            jnp.zeros((self.D, params.m), dtype=jnp.uint8))

    def _put_batch(self, b: Batch, fields=("codes", "quals", "mask",
                                           "rgs", "seconds", "read_ids")):
        """Ship only the arrays the pass reads (passes 1-2: codes [+ids];
        quals/mask/rgs/seconds are pass-3/4 inputs) — round-2 VERDICT
        weak #5: the old 6-array put wasted interconnect bytes per batch."""
        src = {"codes": b.codes, "quals": b.quals, "mask": b.mask,
               "rgs": b.rgs, "seconds": b.seconds,
               "read_ids": b.read_ids}
        return tuple(self._shard_rows(src[kk]) for kk in fields)

    # ------------------------------------------------------------ passes
    def run_pass1(self, batches: Iterable[Batch]) -> None:
        slots_dm = self._empty_replicas(self.params_a)
        for b in batches:
            codes, rids = self._put_batch(b, ("codes", "read_ids"))
            slots_dm = self.steps["sample"](slots_dm, codes, rids,
                                            self.threshold)
        self.bloom_a_merged = self.steps["merge_bloom"](slots_dm)

    def run_pass2(self, batches: Iterable[Batch]) -> None:
        slots_dm = self._empty_replicas(self.params_b)
        for b in batches:
            codes, = self._put_batch(b, ("codes",))
            slots_dm = self.steps["trusted"](self.bloom_a_merged, slots_dm,
                                             codes, self.t_table)
        self.bloom_b_merged = self.steps["merge_bloom"](slots_dm)

    def run_pass3(self, batches: Iterable[Batch]) -> None:
        epoch = 0
        for b in batches:
            codes, quals, mask, rgs, seconds = self._put_batch(
                b, ("codes", "quals", "mask", "rgs", "seconds"))
            self.cov_dm = self.steps["covariates"](
                self.bloom_b_merged, self.cov_dm, codes, quals, mask,
                rgs, seconds)
            epoch += 1
            if epoch >= self.cov.flush_every:
                self._flush_cov()
                epoch = 0
        self._flush_cov()

    def _flush_cov(self) -> None:
        # plain asarray then astype: one bulk transfer, widened on host
        s = {kk: np.asarray(v).astype(np.int64).sum(axis=0)
             for kk, v in self.cov_dm.items()}
        self.cov.totals.cyc_total += s["cyc_total"]
        self.cov.totals.cyc_errors += s["cyc_errors"]
        self.cov.totals.din_total += s["din_total"]
        self.cov.totals.din_errors += s["din_errors"]
        self.cov_dm = self._dev_tables()

    def compute_recal_table(self) -> np.ndarray:
        self.recal_table = build_recal_table(self.cov.totals)
        self._recal_dev = self._replicate(jnp.asarray(self.recal_table))
        return self.recal_table

    def set_recal_table(self, table) -> None:
        """Install an externally-built Q' table (apply-report mode, P9)."""
        self.recal_table = np.asarray(table, np.int8)
        self._recal_dev = self._replicate(jnp.asarray(self.recal_table))

    def apply_recal(self, b: Batch):
        codes, quals, mask, rgs, seconds = self._put_batch(
            b, ("codes", "quals", "mask", "rgs", "seconds"))
        return self.steps["recal"](self._recal_dev, codes, quals, mask,
                                   rgs, seconds)

    def run_pass4(self, batches: Iterable[Batch]) -> np.ndarray:
        outs = []
        for b in batches:
            outs.append(np.asarray(self.apply_recal(b))[:b.num_real])
        return np.concatenate(outs, axis=0) if outs else np.zeros((0, 0))


def sharded_recalibrate_arrays(arrays: ReadArrays, config: RecalConfig,
                               mesh: Mesh | None = None,
                               start_ordinal: int = 0,
                               checkpoint_dir: str | None = None
                               ) -> np.ndarray:
    k = config.k
    lens = arrays.mask.sum(axis=1)
    total_bases = int(lens.sum())
    total_kmers = int(np.maximum(lens - k + 1, 0).sum())
    num_rg = int(arrays.rgs.max(initial=0)) + 1
    pipe = ShardedRecalPipeline(config, num_rg, arrays.max_len, total_bases,
                                total_kmers, mesh)
    mk = lambda: Batcher(arrays, config.batch_size, start_ordinal)

    # pass-boundary checkpoints hold the PACKED row view (the merged,
    # replicated query state) rather than the per-replica byte staging
    ckpt = None
    if checkpoint_dir:
        from ..state.checkpoint import Checkpoint, run_fingerprint
        ckpt = Checkpoint(checkpoint_dir)
        ckpt.check_fingerprint(run_fingerprint(config, arrays))

    rows = ckpt.load_array("rows_a") if ckpt else None
    if rows is not None:
        pipe.bloom_a_merged = pipe._replicate(jnp.asarray(rows))
    else:
        pipe.run_pass1(mk())
        if ckpt:
            ckpt.save_array("rows_a", pipe.bloom_a_merged)

    rows = ckpt.load_array("rows_b") if ckpt else None
    if rows is not None:
        pipe.bloom_b_merged = pipe._replicate(jnp.asarray(rows))
    else:
        pipe.run_pass2(mk())
        if ckpt:
            ckpt.save_array("rows_b", pipe.bloom_b_merged)

    loaded = ckpt.load_covariates() if ckpt else None
    if loaded is not None:
        pipe.cov.totals = loaded
    else:
        pipe.run_pass3(mk())
        if ckpt:
            ckpt.save_covariates(pipe.cov.totals)

    pipe.compute_recal_table()
    return pipe.run_pass4(mk())
