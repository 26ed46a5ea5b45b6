"""Multi-host runtime (BASELINE config 5; SURVEY.md §3.3 / §6).

`jax.distributed.initialize` + GSPMD global arrays; every collective —
within a host and across hosts — goes through the same shard_map
programs as single-host (kbbq_tpu/parallel/sharded*.py), which operate
on global arrays and are host-count agnostic.

This module provides the host-side glue that cannot be expressed in XLA:
process initialization, per-host input partitioning, and global-array
assembly from host-local batches.  It is exercised in CI via the
single-process CPU mesh (the collective programs are identical); real
multi-host runs only need `init_multihost()` + per-host file lists.
"""

from __future__ import annotations

import dataclasses
import os

import jax
import numpy as np


def init_multihost(coordinator: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None) -> dict:
    """Initialize jax.distributed (no-op when single-process).

    Args resolve from env (JAX_COORDINATOR, JAX_NUM_PROCESSES,
    JAX_PROCESS_ID) when not given.
    """
    coordinator = coordinator or os.environ.get("JAX_COORDINATOR")
    num_processes = num_processes or int(
        os.environ.get("JAX_NUM_PROCESSES", "1"))
    process_id = process_id if process_id is not None else int(
        os.environ.get("JAX_PROCESS_ID", "0"))
    if num_processes > 1:
        jax.distributed.initialize(
            coordinator_address=coordinator,
            num_processes=num_processes, process_id=process_id)
    return {
        "process_id": process_id,
        "num_processes": num_processes,
        "local_devices": jax.local_device_count(),
        "global_devices": jax.device_count(),
    }


@dataclasses.dataclass
class HostShard:
    """This host's slice of the global read stream.

    Every file keeps its CANONICAL global start ordinal (cumulative read
    count in the original input order) and read-group id regardless of
    which host processes it — the sampling hash keys on global ordinals
    (DECISIONS.md D5), so output bits are independent of the host count
    and of the assignment (SURVEY.md H5).

    paths: [(path, start_ordinal)] for this host;
    rg_ids / read_counts: parallel lists (rg = original file index).
    """
    paths: list
    start_ordinal: int
    rg_ids: list = dataclasses.field(default_factory=list)
    read_counts: list = dataclasses.field(default_factory=list)

    @property
    def total_reads(self) -> int:
        return int(sum(self.read_counts))


def partition_inputs(paths: list, read_counts: list,
                     process_id: int, num_processes: int) -> HostShard:
    """Greedy LPT bin-packing by read count: biggest file first onto the
    least-loaded host.  Replaces round 1's round-robin, whose load was
    pathological for skewed file sizes (round-1 VERDICT weak-item 6).
    Deterministic (ties -> lower file index -> lower host id), so every
    process computes the identical assignment without communication.
    """
    assert len(paths) == len(read_counts)
    cum = [0]
    for n in read_counts:
        cum.append(cum[-1] + n)
    order = sorted(range(len(paths)),
                   key=lambda i: (-read_counts[i], i))
    loads = [0] * num_processes
    assign: list[list[int]] = [[] for _ in range(num_processes)]
    for i in order:
        h = min(range(num_processes), key=lambda j: (loads[j], j))
        assign[h].append(i)
        loads[h] += read_counts[i]
    mine = sorted(assign[process_id])  # original order within the host
    return HostShard(
        paths=[(paths[i], cum[i]) for i in mine],
        start_ordinal=cum[mine[0]] if mine else 0,
        rg_ids=[i for i in mine],
        read_counts=[read_counts[i] for i in mine])


def make_global_batch(mesh, host_arrays: dict):
    """Assemble a global array from per-host local batches.

    host_arrays: dict of numpy arrays whose leading dim is this host's
    local batch rows.  Uses
    jax.make_array_from_process_local_data so each host contributes its
    shard without materializing the global array anywhere.
    """
    from jax.sharding import NamedSharding, PartitionSpec as P

    out = {}
    for k, v in host_arrays.items():
        spec = P(mesh.axis_names[0], *([None] * (v.ndim - 1)))
        sharding = NamedSharding(mesh, spec)
        out[k] = jax.make_array_from_process_local_data(sharding, v)
    return out


# --------------------------------------------------------------------------
# Multi-host streaming driver (BASELINE config 5)
# --------------------------------------------------------------------------

class MultihostRecalPipeline:
    """Replicated-Bloom sharded pipeline over a MULTI-PROCESS global mesh.

    Reuses the exact shard_map step programs of parallel/sharded.py (the
    collectives are host-count agnostic); only host-side array placement
    differs: global batches assemble from process-local rows, and host
    reads of device state go through fully-replicated arrays (a
    replicated jax.Array is addressable on every process, so np.asarray
    stays legal where the single-host path used it).
    """

    def __init__(self, config, num_rg: int, max_len: int,
                 total_bases: int, total_kmers: int, mesh, num_processes:
                 int, process_id: int):
        import jax.numpy as jnp
        from jax.sharding import NamedSharding, PartitionSpec as P

        from ..oracle.kmers import alpha_threshold
        from ..oracle.lighter import coverage_thresholds
        from ..ops.covariate import new_covariate_state
        from ..state.covariate import CovariateAccumulator
        from .sharded import build_sharded_steps

        self.mesh = mesh
        self.H = num_processes
        self.pid = process_id
        self.D = mesh.devices.size
        self.config = config
        self.num_rg = num_rg
        self.max_len = max_len
        if config.batch_size % self.D:
            raise ValueError(
                f"global batch size {config.batch_size} must divide the "
                f"{self.D}-device mesh")
        if config.batch_size % self.H:
            raise ValueError("global batch size must divide process count")
        self.local_batch = config.batch_size // self.H
        self.alpha, self.coverage = config.resolve_alpha(total_bases)
        self.threshold = jnp.uint32(alpha_threshold(self.alpha))
        self._P = P
        self._NS = NamedSharding
        self.t_table = self._replicate(jnp.asarray(
            coverage_thresholds(self.alpha, config.k), dtype=jnp.int32))
        from ..oracle.bloom import check_layout_capacity
        from ..oracle.pipeline import bloom_params_for
        self.params_a, self.params_b = bloom_params_for(
            config, total_kmers, self.alpha, self.coverage)
        for p in (self.params_a, self.params_b):
            # multi-host replicated byte staging per chip (the sharded
            # hash-space layout is single-host today)
            check_layout_capacity(p, 31, "multi-host replicated",
                                  "lower bits/key or split the input")
        self.steps = build_sharded_steps(mesh, config.k, config.num_hashes,
                                         config.trust_threshold,
                                         config.ext_cap)
        self.cov = CovariateAccumulator(num_rg, max_len,
                                        config.batch_size * max_len)
        self._new_covariate_state = new_covariate_state
        self.cov_dm = self._dev_tables()
        self.recal_table = None

        import functools

        @functools.partial(jax.jit,
                           out_shardings=NamedSharding(mesh, P()))
        def _sum_replicas(tree):
            return jax.tree.map(lambda v: v.sum(axis=0), tree)

        self._sum_replicas = _sum_replicas

    # ------------------------------------------------------------ placement
    def _replicate(self, x):
        return jax.make_array_from_process_local_data(
            self._NS(self.mesh, self._P()), np.asarray(x))

    def _shard0(self, local_rows):
        """Global array sharded on axis 0, assembled from this process's
        rows (leading dim = local share)."""
        spec = self._P(self.mesh.axis_names[0],
                       *([None] * (np.ndim(local_rows) - 1)))
        return jax.make_array_from_process_local_data(
            self._NS(self.mesh, spec), np.asarray(local_rows))

    def _dev_tables(self):
        base = self._new_covariate_state(self.num_rg, self.max_len)
        d_local = self.D // self.H
        return {kk: self._shard0(
            np.zeros((d_local,) + v.shape, np.asarray(v).dtype))
            for kk, v in base.items()}

    def _empty_replicas(self, params):
        d_local = self.D // self.H
        return self._shard0(np.zeros((d_local, params.m), dtype=np.uint8))

    def _put_batch(self, b, fields=("codes", "quals", "mask", "rgs",
                                    "seconds", "read_ids")):
        """LOCAL Batch (local_batch rows) -> global device arrays.

        `fields` limits what crosses the interconnect to what the pass actually
        reads: passes 1-2 need only codes (+ ids for sampling) — quals/
        mask/rgs/seconds are pass-3/4 inputs (round-2 VERDICT weak #5).
        """
        src = {"codes": b.codes, "quals": b.quals, "mask": b.mask,
               "rgs": b.rgs, "seconds": b.seconds,
               "read_ids": b.read_ids}
        g = make_global_batch(self.mesh,
                              {kk: src[kk] for kk in fields})
        return tuple(g[kk] for kk in fields)

    # ------------------------------------------------------------ passes
    def run_pass1(self, batches) -> None:
        slots_dm = self._empty_replicas(self.params_a)
        for b in batches:
            codes, rids = self._put_batch(b, ("codes", "read_ids"))
            slots_dm = self.steps["sample"](slots_dm, codes, rids,
                                            self.threshold)
        self.bloom_a_merged = self.steps["merge_bloom"](slots_dm)

    def run_pass2(self, batches) -> None:
        slots_dm = self._empty_replicas(self.params_b)
        for b in batches:
            codes, = self._put_batch(b, ("codes",))
            slots_dm = self.steps["trusted"](self.bloom_a_merged, slots_dm,
                                             codes, self.t_table)
        self.bloom_b_merged = self.steps["merge_bloom"](slots_dm)

    def run_pass3(self, batches) -> None:
        for b in batches:
            codes, quals, mask, rgs, seconds = self._put_batch(
                b, ("codes", "quals", "mask", "rgs", "seconds"))
            self.cov_dm = self.steps["covariates"](
                self.bloom_b_merged, self.cov_dm, codes, quals, mask,
                rgs, seconds)
        summed = self._sum_replicas(self.cov_dm)  # replicated ->
        # addressable on every process
        s = {kk: np.asarray(v).astype(np.int64)
             for kk, v in summed.items()}
        self.cov.totals.cyc_total += s["cyc_total"]
        self.cov.totals.cyc_errors += s["cyc_errors"]
        self.cov.totals.din_total += s["din_total"]
        self.cov.totals.din_errors += s["din_errors"]
        self.cov_dm = self._dev_tables()

    def compute_recal_table(self):
        from ..oracle.gatk import build_recal_table
        self.recal_table = build_recal_table(self.cov.totals)
        return self.recal_table

    def apply_recal_local(self, b):
        """Pass 4 is a pure local gather (replicated table, no
        collectives) — each host recalibrates its own reads."""
        import jax.numpy as jnp

        from ..ops.recal import apply_recal_table
        if self._recal_local is None:
            self._recal_local = jnp.asarray(self.recal_table)
        return apply_recal_table(
            self._recal_local, jnp.asarray(b.codes),
            jnp.asarray(b.quals), jnp.asarray(b.mask),
            jnp.asarray(b.rgs), jnp.asarray(b.seconds))

    _recal_local = None


_SHARDED_IMPL_CLS = None


def MultihostShardedBloomPipeline(*a, **kw):
    """Hash-space-sharded Bloom over a MULTI-PROCESS global mesh.

    BASELINE config 5 at real WGS sizing: the packed filters shard
    across ALL pod devices, so each host materializes only its devices'
    words — per-host filter memory is O(m / num_hosts), not O(m).
    Factory (the implementation class is built once, lazily, so this
    module's import stays light): subclasses
    parallel/sharded_bloom.py's pipeline, replacing array PLACEMENT
    only — every global array assembles from process-local rows
    (jax.make_array_from_process_local_data), and host folds read
    fully-replicated reductions instead of raw shards.  The shard_map
    step programs are identical; their collectives are host-agnostic.
    """
    return _sharded_impl_cls()(*a, **kw)


def _sharded_impl_cls():
    global _SHARDED_IMPL_CLS
    if _SHARDED_IMPL_CLS is None:
        from .sharded_bloom import ShardedBloomRecalPipeline

        class _Impl(ShardedBloomRecalPipeline):
            def __init__(self, config, num_rg, max_len, total_bases,
                         total_kmers, mesh, num_processes, process_id):
                from jax.sharding import NamedSharding, PartitionSpec as P
                self.H = num_processes
                self.pid = process_id
                if config.batch_size % num_processes:
                    raise ValueError(
                        "global batch size must divide process count")
                self.local_batch = config.batch_size // num_processes
                self._NS, self._P = NamedSharding, P
                super().__init__(config, num_rg, max_len, total_bases,
                                 total_kmers, mesh)
                import functools

                @functools.partial(
                    jax.jit, out_shardings=NamedSharding(mesh, P()))
                def _sum_replicas(tree):
                    return jax.tree.map(lambda v: v.sum(axis=0), tree)

                self._sum_replicas = _sum_replicas

            # ------------------------------------------- placement
            def _replicate(self, x):
                return jax.make_array_from_process_local_data(
                    self._NS(self.mesh, self._P()), np.asarray(x))

            def _shard_rows(self, x):
                """x = THIS PROCESS's leading-axis share."""
                x = np.asarray(x)
                spec = self._P(self.mesh.axis_names[0],
                               *([None] * (x.ndim - 1)))
                return jax.make_array_from_process_local_data(
                    self._NS(self.mesh, spec), x)

            def _empty_rows(self, params):
                d_local = self.D // self.H
                local_words = (params.m // 32) // self.D * d_local
                return self._shard_rows(
                    np.zeros(local_words, np.uint32))

            def _dev_tables(self):
                from ..ops.covariate import new_covariate_state
                base = new_covariate_state(self.num_rg, self.max_len)
                d_local = self.D // self.H
                return {kk: self._shard_rows(
                    np.zeros((d_local,) + np.asarray(v).shape,
                             np.asarray(v).dtype))
                    for kk, v in base.items()}

            def _fold_cov(self):
                summed = self._sum_replicas(self.cov_dm)  # replicated
                s = {kk: np.asarray(v).astype(np.int64)
                     for kk, v in summed.items()}
                self.cov.totals.cyc_total += s["cyc_total"]
                self.cov.totals.cyc_errors += s["cyc_errors"]
                self.cov.totals.din_total += s["din_total"]
                self.cov.totals.din_errors += s["din_errors"]
                self.cov_dm = self._dev_tables()

            # pass 4 is a pure LOCAL gather (replicated host table) —
            # same as MultihostRecalPipeline.apply_recal_local
            _recal_local = None

            def apply_recal_local(self, b):
                import jax.numpy as jnp

                from ..ops.recal import apply_recal_table
                if self._recal_local is None:
                    self._recal_local = jnp.asarray(self.recal_table)
                return apply_recal_table(
                    self._recal_local, jnp.asarray(b.codes),
                    jnp.asarray(b.quals), jnp.asarray(b.mask),
                    jnp.asarray(b.rgs), jnp.asarray(b.seconds))

        _SHARDED_IMPL_CLS = _Impl
    return _SHARDED_IMPL_CLS


def _make_mh_pipeline(config, num_rg, max_len, total_bases, total_kmers,
                      mesh, H, pid, bloom_layout: str):
    """Multi-host pipeline for the requested Bloom placement;
    'auto' shards once the filters outgrow the replicated budget."""
    if bloom_layout == "auto":
        from ..oracle.pipeline import bloom_params_for
        from ..utils.mem import device_budget
        alpha, coverage = config.resolve_alpha(total_bases)
        pa, pb = bloom_params_for(config, total_kmers, alpha, coverage)
        bloom_layout = ("replicated"
                        if pa.m + pb.m <= device_budget("replicated")
                        else "sharded")
    if bloom_layout == "sharded":
        return MultihostShardedBloomPipeline(
            config, num_rg, max_len, total_bases, total_kmers, mesh,
            H, pid), "sharded"
    return MultihostRecalPipeline(
        config, num_rg, max_len, total_bases, total_kmers, mesh,
        H, pid), "replicated"


def _empty_batch(batch_size: int, max_len: int):
    """All-pad Batch: contributes nothing to any pass (mask False,
    invalid codes, sentinel ordinals) — used to equalize the global
    step count across hosts so collectives rendezvous."""
    from ..io.batcher import Batch
    return Batch(
        codes=np.full((batch_size, max_len), 4, np.int8),
        quals=np.zeros((batch_size, max_len), np.int8),
        mask=np.zeros((batch_size, max_len), bool),
        rgs=np.zeros(batch_size, np.int32),
        seconds=np.zeros(batch_size, bool),
        read_ids=np.full(batch_size, 0xFFFFFFFF, np.uint32),
        num_real=0)


def _padded_stream(source, total_steps: int, batch_size: int,
                   max_len: int):
    n = 0
    for b in source:
        yield b
        n += 1
    while n < total_steps:
        yield _empty_batch(batch_size, max_len)
        n += 1


def host_steps_per_pass(read_counts_by_host, local_batch: int) -> int:
    """Global step count per pass = the busiest host's batch count.
    Deterministic from the partition, so no communication is needed."""
    def steps(counts):
        return sum((n + local_batch - 1) // local_batch for n in counts)
    return max((steps(c) for c in read_counts_by_host), default=0)


def recalibrate_fastq_multihost(in_paths, out_paths, config,
                                interleaved: bool = False,
                                chunk_reads: int | None = None,
                                info: dict | None = None,
                                checkpoint_dir: str | None = None,
                                bloom_layout: str = "auto",
                                report_out: str | None = None,
                                apply_report: str | None = None) -> dict:
    """Streaming multi-host data-parallel recalibration (config 5).

    Every process calls this with the SAME arguments (shared filesystem);
    each host streams only its partition of the input files, global
    batches assemble across hosts via the process-local-data API, and
    each host writes the outputs for its own files.  out_paths: list of
    per-input output paths (a single concatenated sink is impossible
    across hosts).  Output bytes are identical to the single-host
    pipeline (ordinal-keyed sampling + integer-commutative merges).

    checkpoint_dir (shared filesystem): pass-boundary checkpoints —
    merged Bloom rows and covariate totals are replicated, so process 0
    saves the shared artifacts once and every restarted process reloads
    them; pass-4 progress is per-host (host{pid}.json) with file/chunk/
    byte offsets, so a host failure reruns only from the last saved
    pass instead of the whole job (SURVEY.md §6 failure/recovery row).
    """
    from ..io.stream import (DEFAULT_CHUNK_READS, StreamingBatches,
                             chunk_to_batch_arrays, iter_fastq_chunks,
                             prefetch_iter, scan_fastq_files,
                             _slice_batches)
    from ..io.fastq import write_fastq_with_quals
    from .mesh import make_mesh

    info = info or init_multihost()
    H, pid = info["num_processes"], info["process_id"]
    if isinstance(in_paths, (str, bytes)):
        in_paths = [in_paths]
    if not isinstance(out_paths, (list, tuple)) or \
            len(out_paths) != len(in_paths):
        raise ValueError(
            "multi-host mode needs one output path per input file")
    k = config.k
    mesh = make_mesh()  # all global devices

    scan = scan_fastq_files(in_paths, k)
    shard = partition_inputs(in_paths, scan.per_file_reads, pid, H)
    all_shards = [partition_inputs(in_paths, scan.per_file_reads, h, H)
                  for h in range(H)]

    local_batch = config.batch_size // H
    chunk = chunk_reads or DEFAULT_CHUNK_READS
    chunk = ((chunk + local_batch - 1) // local_batch) * local_batch
    steps = host_steps_per_pass(
        [s.read_counts for s in all_shards], local_batch)

    pipe, _kind = _make_mh_pipeline(
        config, len(in_paths), scan.max_len, scan.total_bases,
        scan.total_kmers(k), mesh, H, pid, bloom_layout)

    file_specs = [(p, rg, o) for (p, o), rg in
                  zip(shard.paths, shard.rg_ids)]

    def mk():
        src = StreamingBatches(
            [], local_batch, scan.max_len, chunk, interleaved,
            file_specs=file_specs)
        return _padded_stream(iter(src), steps, local_batch,
                              scan.max_len)

    ckpt = None
    if checkpoint_dir and apply_report is None:
        from ..state.checkpoint import Checkpoint, stream_fingerprint
        ckpt = Checkpoint(checkpoint_dir)
        fp = stream_fingerprint(config, in_paths, scan)
        fp["num_processes"] = H     # resume requires the same topology
        fp["bloom_layout"] = _kind  # shard artifacts differ per layout
        # pass-4 resume offsets are in CHUNK units and pairing flips
        # pass-3/4 covariates — both must match to resume
        fp["chunk_reads"] = chunk
        fp["interleaved"] = bool(interleaved)
        ckpt.check_fingerprint(fp)

    _run_mh_passes_or_apply(pipe, mk, ckpt, pid,
                            [str(p) for p in in_paths], scan.max_len,
                            report_out, apply_report)

    # pass 4: local, per owned file (.gz sinks BGZF-compress); with a
    # checkpoint, per-host file/chunk/byte offsets resume mid-file on
    # plain sinks (a .gz sink restarts its file — compressed streams
    # are not seek-resumable)
    from ..io.fastq import is_gz_path, open_fastq_sink
    from contextlib import closing

    hm = ckpt.load_host_meta(pid) if ckpt else {}
    files_done = int(hm.get("files_done", 0))
    done_chunks = int(hm.get("chunks", 0))
    done_bytes = int(hm.get("bytes", 0))

    written = 0
    for fi, ((path, start), rg) in enumerate(
            zip(shard.paths, shard.rg_ids)):
        if fi < files_done:
            written += shard.read_counts[fi]
            continue
        out = out_paths[rg]
        resume_here = (ckpt is not None and fi == files_done
                       and done_chunks > 0 and not is_gz_path(out))
        if resume_here:
            sink_f = open(out, "r+b")
            sink_f.truncate(done_bytes)
            sink_f.seek(done_bytes)
        else:
            sink_f = open_fastq_sink(out)
            done_chunks = 0
        with closing(sink_f) as sink:
            ordinal = start
            def chunks():
                nonlocal ordinal
                for fq in iter_fastq_chunks(path, chunk):
                    yield fq, ordinal
                    ordinal += fq.num_reads
            for ci, (fq, o) in enumerate(prefetch_iter(chunks(),
                                                       depth=2)):
                if ci < done_chunks:
                    written += fq.num_reads
                    continue
                arrs = chunk_to_batch_arrays(fq, scan.max_len, rg, o,
                                             interleaved)
                rows = []
                for b in _slice_batches(arrs, local_batch, scan.max_len):
                    rows.append(
                        np.asarray(pipe.apply_recal_local(b))[:b.num_real])
                nq = np.concatenate(rows, axis=0)
                write_fastq_with_quals(fq, nq, arrs[2], sink)
                written += fq.num_reads
                if ckpt and not is_gz_path(out):
                    sink.flush()
                    ckpt.save_host_meta(pid, {
                        "files_done": fi, "chunks": ci + 1,
                        "bytes": sink.tell()})
        done_chunks = 0
        if ckpt:
            ckpt.save_host_meta(pid, {"files_done": fi + 1,
                                      "chunks": 0, "bytes": 0})

    return {"num_reads": scan.num_reads,
            "total_bases": scan.total_bases,
            "read_groups": len(in_paths),
            "host_reads_written": written,
            "process_id": pid, "num_processes": H,
            "devices": mesh.devices.size}


# --------------------------------------------------------------------------
# Multi-host BAM (round-3 VERDICT #7; SURVEY.md C6/§3.3)
# --------------------------------------------------------------------------


def scan_bam_multihost(path: str, k: int, chunk_records: int):
    """Deterministic whole-file metadata scan every host runs
    identically (no communication): per-chunk (n_records, n_primary,
    primary_ordinal_start, stream_off) plus the global RG registry,
    totals, and max_len.  stream_off is the chunk's start offset in the
    DECOMPRESSED stream; bgzf_member_index maps it to a (member, delta)
    virtual offset so each host later seeks straight to its shard."""
    from ..io.bam_stream import iter_bam_raw_chunks_offsets
    from ..io.bam_vec import scan_chunk

    header_text, refs, chunks, offsets = iter_bam_raw_chunks_offsets(
        path, chunk_records)
    metas = []
    registry: dict = {}
    n = bases = tk = 0
    max_len = 1
    for i, (buf, offs, sizes) in enumerate(chunks):
        cn, cb, ck, cl, keys = scan_chunk(buf, offs, sizes, k)
        metas.append({"n_records": int(offs.size), "n_primary": int(cn),
                      "ordinal": n, "stream_off": offsets[i]})
        n += cn
        bases += cb
        tk += ck
        max_len = max(max_len, cl)
        for key in keys:
            if key not in registry:
                registry[key] = len(registry)
    return header_text, refs, metas, registry, n, bases, tk, max_len


def partition_bam_chunks(metas, num_hosts: int):
    """Contiguous chunk ranges balanced by primary-read count:
    [(chunk_lo, chunk_hi)] per host, deterministic."""
    total = sum(m["n_primary"] for m in metas)
    bounds = [0]
    acc = 0
    for h in range(1, num_hosts):
        target = total * h / num_hosts
        i = bounds[-1]
        while i < len(metas) and acc + metas[i]["n_primary"] <= target:
            acc += metas[i]["n_primary"]
            i += 1
        bounds.append(i)
    bounds.append(len(metas))
    return [(bounds[h], bounds[h + 1]) for h in range(num_hosts)]


class _BamHostBatches:
    """Re-iterable local batches over one host's contiguous chunk range
    (global primary ordinals, machine order, optional OQ quals)."""

    def __init__(self, path, metas, lo, hi, registry, max_len,
                 local_batch, use_oq, chunk_records, members, total_u):
        self.path = path
        self.metas = metas
        self.lo, self.hi = lo, hi
        self.registry = registry
        self.max_len = max_len
        self.local_batch = local_batch
        self.use_oq = use_oq
        self.chunk_records = chunk_records
        self.members, self.total_u = members, total_u

    def raw_chunks(self):
        from ..io.bam_stream import iter_bam_raw_chunks_range, \
            voffset_for
        if self.lo >= self.hi:
            return
        co, delta = voffset_for(self.members, self.total_u,
                                self.metas[self.lo]["stream_off"])
        n_rec = sum(m["n_records"] for m in self.metas[self.lo:self.hi])
        yield from iter_bam_raw_chunks_range(
            self.path, co, delta, n_rec, self.chunk_records)

    def __iter__(self):
        from ..io.bam_vec import decode_machine_chunk
        from ..io.stream import _slice_batches, prefetch_iter

        def decoded():
            for ci, (buf, offs, sizes) in enumerate(self.raw_chunks()):
                meta = self.metas[self.lo + ci]
                dec = decode_machine_chunk(buf, offs, sizes,
                                           self.max_len, self.registry,
                                           use_oq=self.use_oq)
                codes, quals, mask, rgs, seconds, _, prim = dec
                if not prim.size:
                    continue
                ids = np.arange(meta["ordinal"],
                                meta["ordinal"] + prim.size,
                                dtype=np.uint32)
                yield codes, quals, mask, rgs, seconds, ids

        for arrs in prefetch_iter(decoded(), depth=2):
            yield from _slice_batches(arrs, self.local_batch,
                                      self.max_len)


class _CramHostBatches:
    """Re-iterable local batches over one host's contiguous CONTAINER
    range (global primary ordinals) — the CRAM twin of _BamHostBatches;
    containers are the shardable unit the round-4 VERDICT named (the
    streamer's scan already yields their record counts)."""

    def __init__(self, path, fasta_ref, metas, lo, hi, registry,
                 rg_names, max_len, local_batch, use_oq):
        self.path = path
        self.metas = metas
        self.lo, self.hi = lo, hi
        self.registry = registry
        self.rg_names = rg_names
        self.max_len = max_len
        self.local_batch = local_batch
        self.use_oq = use_oq
        self.refs = None
        if fasta_ref:
            from ..benchmark import read_fasta
            self.refs = read_fasta(fasta_ref)
        lut = np.zeros(len(rg_names) + 1, np.int32)
        lut[0] = registry.get("", 0)
        for i, nm in enumerate(rg_names):
            lut[i + 1] = registry.get(nm, 0)
        self.rg_lut = lut

    def containers(self):
        """(container_index, cont, blocks, raw) over [lo, hi) —
        containers before lo are header-seeked, not decoded (a full
        decode-and-discard made aggregate pod decode work O(hosts x
        file) per pass; round-5 self-review #7)."""
        from ..io.cram import CramStream
        if self.lo >= self.hi:
            return
        with CramStream(self.path) as cs:
            self._ref_names = cs.ref_names
            for off, (cont, blocks, raw) in enumerate(
                    cs.containers(skip=self.lo)):
                ci = self.lo + off
                if ci >= self.hi:
                    break
                yield ci, cont, blocks, raw

    def decoded_containers(self):
        """(ci, cont, blocks, raw, slices) per owned container."""
        from ..io.cram import parse_compression_header
        from ..pipeline.cram_stream import _decode_container
        for ci, cont, blocks, raw in self.containers():
            comp = parse_compression_header(blocks[0].data)
            slices = _decode_container(
                comp, blocks, cont, self.refs, self._ref_names,
                self.rg_names, self.max_len, self.rg_lut,
                self.registry, self.use_oq)
            yield ci, cont, blocks, raw, slices

    def __iter__(self):
        from ..io.stream import _slice_batches, prefetch_iter
        from ..pipeline.cram_stream import _slow_arrays

        def decoded():
            for ci, cont, blocks, raw, slices in \
                    self.decoded_containers():
                ordinal = self.metas[ci]["ordinal"]
                for kind, payload, _ in slices:
                    if kind == "fast":
                        codes, quals, mask, rgs, seconds, lens, prim, \
                            _n = payload
                    else:
                        codes, quals, mask, rgs, seconds, lens, prim = \
                            _slow_arrays(payload, self.max_len,
                                         self.registry, self.rg_names,
                                         self.use_oq)
                    if prim.size:
                        ids = np.arange(ordinal, ordinal + prim.size,
                                        dtype=np.uint32)
                        yield codes, quals, mask, rgs, seconds, ids
                    ordinal += prim.size

        for arrs in prefetch_iter(decoded(), depth=2):
            yield from _slice_batches(arrs, self.local_batch,
                                      self.max_len)


def recalibrate_cram_multihost(in_path: str, out_path: str, config,
                               use_oq: bool = False,
                               fasta_ref: str | None = None,
                               info: dict | None = None,
                               checkpoint_dir: str | None = None,
                               bloom_layout: str = "auto",
                               report_out: str | None = None,
                               apply_report: str | None = None) -> dict:
    """Streaming multi-host CRAM recalibration (SURVEY.md C6/C7).

    Every process runs this with the same arguments; each host scans
    the container metadata deterministically, takes a contiguous
    container range, and writes `{out}.part-XXXX-of-YYYY` — host 0's
    part carries the CRAM file definition + header container, the last
    host's the EOF container, so `cat out.part-* > out.cram` is a valid
    single CRAM.  Fast-profile containers are rewritten by the pass-4
    QS-block surgery (every non-QS byte verbatim), so the concatenation
    is byte-identical to the single-host streaming output; fallback
    containers re-encode through write_cram's profile."""
    from ..io.cram_write import CramStreamWriter, rewrite_container_quals
    from ..io.stream import prefetch_iter
    from ..pipeline.cram_stream import (
        container_new_qs,
        rewrite_fallback_container,
        scan_cram_meta,
    )
    from .mesh import make_mesh

    info = info or init_multihost()
    H, pid = info["num_processes"], info["process_id"]
    k = config.k
    mesh = make_mesh()

    metas, n, bases, tk, max_len, registry, rg_names, header_text = \
        scan_cram_meta(in_path, k, fasta_ref, use_oq)
    ranges = partition_bam_chunks(metas, H)   # generic over n_primary
    lo, hi = ranges[pid]

    local_batch = config.batch_size // H
    # batches are emitted per SLICE (one _slice_batches call each), so
    # the cross-host step budget must count them the same way — a
    # per-container ceil under-counts multi-slice containers and the
    # collectives would desynchronize
    steps = max(
        (sum((sp + local_batch - 1) // local_batch
             for m in metas[a:b] for sp in m["slice_prims"] if sp)
         for a, b in ranges), default=0)

    pipe, _kind = _make_mh_pipeline(
        config, max(1, len(registry)), max_len, bases, tk, mesh, H, pid,
        bloom_layout)

    def mk():
        src = _CramHostBatches(in_path, fasta_ref, metas, lo, hi,
                               registry, rg_names, max_len, local_batch,
                               use_oq)
        return _padded_stream(iter(src), steps, local_batch, max_len)

    ckpt = None
    if checkpoint_dir and apply_report is None:
        from ..state.checkpoint import Checkpoint, effective_ext_cap
        ckpt = Checkpoint(checkpoint_dir)
        fp = {"k": k, "alpha": config.alpha, "coverage": config.coverage,
              "genome_length": config.genome_length,
              "num_hashes": config.num_hashes,
              "trust_threshold": config.trust_threshold,
              "ext_cap": effective_ext_cap(config), "use_oq": use_oq,
              "num_reads": n, "total_bases": bases, "cram": True,
              "num_processes": H, "bloom_layout": _kind}
        ckpt.check_fingerprint(fp)

    from ..pipeline.bam import _registry_names
    _run_mh_passes_or_apply(pipe, mk, ckpt, pid,
                            _registry_names(registry), max_len,
                            report_out, apply_report)
    recal = pipe.recal_table

    # pass 4: rewrite own container range into this host's part file
    # (a resumed run rewrites the whole part, like BAM)
    part = f"{out_path}.part-{pid:04d}-of-{H:04d}"
    writer = CramStreamWriter(part, header_text, rg_names,
                              write_header=(pid == 0),
                              write_eof=(pid == H - 1))
    written = 0
    src = _CramHostBatches(in_path, fasta_ref, metas, lo, hi, registry,
                           rg_names, max_len, local_batch, use_oq)
    try:
        for ci, cont, blocks, raw, slices in prefetch_iter(
                src.decoded_containers(), depth=2):
            if all(kind == "fast" for kind, _, _ in slices):
                qs_new = container_new_qs(slices, blocks, recal, max_len)
                writer.write_raw(
                    rewrite_container_quals(cont, blocks, raw, qs_new))
            else:
                recs_all = rewrite_fallback_container(
                    slices, recal, max_len, registry, rg_names, use_oq)
                writer.write_records(recs_all)
            written += metas[ci]["n_primary"]
    finally:
        writer.close()

    return {"num_reads": n, "total_bases": bases,
            "read_groups": max(1, len(registry)),
            "host_reads_written": written,
            "part": part,
            "process_id": pid, "num_processes": H,
            "devices": mesh.devices.size}


def _maybe_crash(point: str, pid: int, state=None) -> None:
    """Failure injection for recovery tests: KBBQ_CRASH_POINT=
    '<point>:<pid>' hard-kills that process at the named point (the
    recovery story SURVEY.md §6 requires must be TESTED by killing a
    real process, not simulated).  `state` is blocked on first so the
    dying host has finished its share of the previous pass's collectives
    — the scenario under test is "host dies between passes", not "dies
    mid-collective" (which correctly loses the un-checkpointed pass)."""
    import os
    if os.environ.get("KBBQ_CRASH_POINT") == f"{point}:{pid}":
        if state is not None:
            jax.block_until_ready(state)
        os._exit(41)


def _local_shard_rows(arr) -> np.ndarray:
    """This process's contiguous leading-axis block of a row-sharded
    global array (the inverse of make_array_from_process_local_data)."""
    shards = sorted(arr.addressable_shards,
                    key=lambda s: s.index[0].start or 0)
    return np.concatenate([np.asarray(s.data) for s in shards], axis=0)


def _run_sharded_mh_passes(pipe, mk, ckpt, pid: int) -> None:
    """Sharded-layout passes 1-3 with per-host shard checkpoints.

    Protocol per pass: every host writes {name}_host{pid}.npy
    atomically -> sync_global_devices barrier -> process 0 marks the
    pass in meta.json.  Skip decisions on restart read the marker, so
    they are consistent across hosts by construction."""
    from jax.experimental import multihost_utils

    def barrier(tag):
        multihost_utils.sync_global_devices(f"kbbq_ckpt_{tag}")

    def run_or_load(name, run, get_state, set_state):
        loaded = ckpt.load_host_array(pid, name) if ckpt else None
        if loaded is not None:
            set_state(loaded)
            return
        run()
        if ckpt:
            ckpt.save_host_array(pid, name, _local_shard_rows(
                get_state()))
            barrier(name)
            if pid == 0:
                ckpt.mark_pass(name)

    run_or_load("mh_sh_rows_a", lambda: pipe.run_pass1(mk()),
                lambda: pipe.packed_a,
                lambda v: setattr(pipe, "packed_a",
                                  pipe._shard_rows(v)))
    _maybe_crash("pass2", pid, pipe.packed_a)
    run_or_load("mh_sh_rows_b", lambda: pipe.run_pass2(mk()),
                lambda: pipe.packed_b,
                lambda v: setattr(pipe, "packed_b",
                                  pipe._shard_rows(v)))

    loaded = ckpt.load_covariates() if ckpt else None
    if loaded is not None:
        pipe.cov.totals = loaded
    else:
        pipe.run_pass3(mk())
        if ckpt:
            # totals are replicated host values — identical everywhere;
            # pid 0 writes once (save_covariates marks atomically after
            # its files land, and a barrier keeps laggards from racing
            # past a crash window with inconsistent views)
            barrier("cov")
            if pid == 0:
                ckpt.save_covariates(pipe.cov.totals)
    pipe.compute_recal_table()


def _run_mh_passes_or_apply(pipe, mk, ckpt, pid: int, rg_names,
                            max_len: int, report_out, apply_report
                            ) -> None:
    """Report-interop-aware multihost pass dispatch (the pod twin of
    pipeline/recalibrate.py::_run_or_apply): apply_report skips the
    model build entirely (every host builds the same table from the
    same report — no collectives, so skips are trivially consistent);
    report_out has process 0 write the GATKReport (covariate totals are
    replicated, identical on every host)."""
    if apply_report is not None:
        from ..gatk_report import read_gatk_report, recal_table_from_report
        pipe.recal_table = recal_table_from_report(
            read_gatk_report(apply_report), rg_names, max_len)
        return
    _run_multihost_passes(pipe, mk, ckpt, pid)
    if report_out is not None and pid == 0:
        from ..gatk_report import write_gatk_report
        write_gatk_report(pipe.cov.totals, rg_names, report_out)


def _run_multihost_passes(pipe, mk, ckpt, pid: int) -> None:
    """Passes 1-3 with pass-boundary checkpoint skip/save (SURVEY.md §6).

    The saved artifacts (merged packed Bloom rows, covariate totals) are
    REPLICATED — bit-identical on every host — so process 0 writes them
    once to the shared checkpoint dir and every restarted process
    reloads the same bytes; skip decisions are therefore consistent
    across hosts and the collectives stay in step.

    The SHARDED layout's filters are NOT replicated: each host saves
    its LOCAL shard, a cross-host barrier confirms every shard landed,
    and only then does process 0 mark the pass complete — so a crash
    mid-save leaves the pass unmarked and every restarted host makes
    the same (re-run) decision."""
    if not isinstance(pipe, MultihostRecalPipeline):
        _run_sharded_mh_passes(pipe, mk, ckpt, pid)
        return

    rows = ckpt.load_array("mh_rows_a") if ckpt else None
    if rows is not None:
        pipe.bloom_a_merged = pipe._replicate(rows)
    else:
        pipe.run_pass1(mk())
        if ckpt and pid == 0:
            ckpt.save_array("mh_rows_a", np.asarray(pipe.bloom_a_merged))
    _maybe_crash("pass2", pid, pipe.bloom_a_merged)  # "mid-pass-2":
    # after the pass-1 checkpoint exists, before pass 2 completes

    rows = ckpt.load_array("mh_rows_b") if ckpt else None
    if rows is not None:
        pipe.bloom_b_merged = pipe._replicate(rows)
    else:
        pipe.run_pass2(mk())
        if ckpt and pid == 0:
            ckpt.save_array("mh_rows_b", np.asarray(pipe.bloom_b_merged))

    loaded = ckpt.load_covariates() if ckpt else None
    if loaded is not None:
        pipe.cov.totals = loaded
    else:
        pipe.run_pass3(mk())
        if ckpt and pid == 0:
            ckpt.save_covariates(pipe.cov.totals)

    pipe.compute_recal_table()


def recalibrate_bam_multihost(in_path: str, out_path: str, config,
                              use_oq: bool = False, set_oq: bool = False,
                              chunk_records: int | None = None,
                              info: dict | None = None,
                              checkpoint_dir: str | None = None,
                              bloom_layout: str = "auto",
                              report_out: str | None = None,
                              apply_report: str | None = None) -> dict:
    """Streaming multi-host BAM recalibration.

    Every process runs this with the same arguments; each host scans
    the file's metadata deterministically, takes a contiguous BGZF
    chunk range (virtual-offset seek, no prefix re-inflation), and
    writes `{out}.part-XXXX-of-YYYY` — host 0's part carries the BAM
    header, the last host's the BGZF EOF marker, so
    `cat out.part-* > out.bam` is a valid single BAM whose records are
    exactly the single-host streaming output's.  Covariates merge over
    the interconnect exactly as the FASTQ pod path (integer-commutative)."""
    from ..io.bam_stream import DEFAULT_CHUNK_RECORDS, BamStreamWriter, \
        bgzf_member_index
    from ..io.bam_vec import rewrite_quals_chunk
    from ..io.stream import prefetch_iter
    from .mesh import make_mesh

    info = info or init_multihost()
    H, pid = info["num_processes"], info["process_id"]
    chunk_records = chunk_records or DEFAULT_CHUNK_RECORDS
    k = config.k
    mesh = make_mesh()

    header_text, refs, metas, registry, n, bases, tk, max_len = \
        scan_bam_multihost(in_path, k, chunk_records)
    members, total_u = bgzf_member_index(in_path)
    ranges = partition_bam_chunks(metas, H)
    lo, hi = ranges[pid]

    local_batch = config.batch_size // H
    steps = max(
        (sum((m["n_primary"] + local_batch - 1) // local_batch
             for m in metas[a:b] if m["n_primary"])
         for a, b in ranges), default=0)

    pipe, _kind = _make_mh_pipeline(
        config, max(1, len(registry)), max_len, bases, tk, mesh, H, pid,
        bloom_layout)

    def mk():
        src = _BamHostBatches(in_path, metas, lo, hi, registry, max_len,
                              local_batch, use_oq, chunk_records,
                              members, total_u)
        return _padded_stream(iter(src), steps, local_batch, max_len)

    ckpt = None
    if checkpoint_dir and apply_report is None:
        from ..state.checkpoint import Checkpoint, effective_ext_cap
        ckpt = Checkpoint(checkpoint_dir)
        fp = {"k": k, "alpha": config.alpha, "coverage": config.coverage,
              "genome_length": config.genome_length,
              "num_hashes": config.num_hashes,
              "trust_threshold": config.trust_threshold,
              "ext_cap": effective_ext_cap(config), "use_oq": use_oq,
              "num_reads": n, "total_bases": bases, "bam": True,
              "num_processes": H, "bloom_layout": _kind}
        ckpt.check_fingerprint(fp)

    from ..pipeline.bam import _registry_names
    _run_mh_passes_or_apply(pipe, mk, ckpt, pid,
                            _registry_names(registry), max_len,
                            report_out, apply_report)

    # pass 4: rewrite own chunk range into this host's part file (a
    # resumed run rewrites the whole part — BGZF parts are not
    # byte-offset resumable mid-stream; the expensive passes 1-3 are
    # what the checkpoints skip)
    from ..io.bam_vec import decode_machine_chunk
    part = f"{out_path}.part-{pid:04d}-of-{H:04d}"
    writer = BamStreamWriter(part, header_text, refs,
                             write_header=(pid == 0),
                             write_eof=(pid == H - 1))
    written = 0
    src = _BamHostBatches(in_path, metas, lo, hi, registry, max_len,
                          local_batch, use_oq, chunk_records,
                          members, total_u)
    try:
        for ci, (buf, offs, sizes) in enumerate(
                prefetch_iter(src.raw_chunks(), depth=2)):
            dec = decode_machine_chunk(buf, offs, sizes, max_len,
                                       registry, use_oq=use_oq)
            codes, quals, mask, rgs, seconds, lens, prim = dec
            if prim.size:
                rows = []
                B = local_batch
                from ..io.stream import _slice_batches
                ids = np.zeros(prim.size, np.uint32)   # unused in p4
                for b in _slice_batches(
                        (codes, quals, mask, rgs, seconds, ids),
                        B, max_len):
                    rows.append(np.asarray(
                        pipe.apply_recal_local(b))[:b.num_real])
                nq = np.concatenate(rows, axis=0)
                writer.write_raw(rewrite_quals_chunk(
                    buf, offs, sizes, prim, lens, nq, set_oq=set_oq))
                written += prim.size
            else:
                writer.write_raw(buf)
    finally:
        writer.close()

    return {"num_reads": n, "total_bases": bases,
            "read_groups": max(1, len(registry)),
            "host_reads_written": written,
            "part": part,
            "process_id": pid, "num_processes": H,
            "devices": mesh.devices.size}
