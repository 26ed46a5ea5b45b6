"""Resident-WINDOW streaming driver: resident-engine performance at
bounded host memory.

The original streaming driver (pipeline/streaming.py) pays one
dispatch per 8k-read batch per pass (~150 dispatches/pass at bench
scale).  This engine streams the input in WINDOWS of `chunk_reads`
reads and runs ONE jit per pass per window, exactly like the in-RAM
resident pipeline
(pipeline/resident.py) does per staged slice:

- pass 1/2: per-window dense sort-built Bloom rows, OR-merged into the
  running filter (OR commutes -> byte-identical to the global build);
- pass 3: per-window walk dispatch (production scheduled engine) with
  sparse error-index d2h + host covariate accumulation on a worker
  thread (the resident design), so d2h hides under the next window;
- pass 4: pure host gather per chunk (ops/recal.py twin) + incremental
  write with chunk-offset resume.

Host memory is O(window); device memory is O(window + filters).
Sampling keys on global ordinals (DECISIONS.md D5), so output bytes are
identical to the in-RAM pipelines for ANY chunk size (tests assert it).

Reference analog: the reference streams all four passes from disk at
full speed (pub:src/kbbq/htsiter.cc, SURVEY.md C6; mount empty, §0).
"""

from __future__ import annotations

import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np

from ..io.fastq import write_fastq_with_quals
from ..io.stream import (
    DEFAULT_CHUNK_READS,
    chunk_to_batch_arrays,
    iter_fastq_chunks,
    prefetch_iter,
    scan_fastq_files,
)
from ..oracle.bloom import BloomParams
from ..oracle.covariate import CovariateTables
from ..oracle.gatk import build_recal_table
from ..oracle.kmers import alpha_threshold
from ..oracle.lighter import coverage_thresholds
from ..ops.bloom import bloom_rows_dense, probe_words
from ..ops.covariate_host import accumulate_covariates_host
from ..ops.inference import WALK_CHUNK
from ..ops.kmers import canonical_kmers_batch, sample_keep_mask
from ..ops.recal import apply_recal_table_host
from ..ops.trusted import trusted_mask_batch
from ..utils.mem import device_budget
from .recalibrate import RecalConfig
from .resident import _pack_error_bits, _pack_quarters, _pass3_walks, \
    _sparse_error_idx, sparse_err_cap


@functools.partial(jax.jit, static_argnames=("L",))
def _expand_window(packed, n_pos, lens, off, nreal, *, L):
    """Device-side window reconstruction (codes, ids) from the packed
    feed — the streaming twin of resident._expand_inputs, with the
    window offset/real-count as TRACED scalars so every full window
    shares one executable."""
    npad = packed.shape[0]
    planes = [((packed >> s) & 3).astype(jnp.int8) for s in (0, 2, 4, 6)]
    codes = jnp.concatenate(planes, axis=1)[:, :L]
    pos = jax.lax.broadcasted_iota(jnp.int32, (npad, L), 1)
    mask = pos < lens[:, None].astype(jnp.int32)
    codes = jnp.where(mask, codes, jnp.int8(4))
    if n_pos.shape[0]:
        codes = codes.reshape(-1).at[n_pos].set(
            jnp.int8(4), mode="drop").reshape(npad, L)
    r = jnp.arange(npad, dtype=jnp.uint32)
    ids = jnp.where(r < nreal.astype(jnp.uint32),
                    off.astype(jnp.uint32) + r, jnp.uint32(0xFFFFFFFF))
    return codes, ids


@functools.partial(jax.jit,
                   static_argnames=("k", "num_hashes", "log2_m", "B"),
                   donate_argnames=("rows_a",))
def _p1_window(rows_a, codes, ids, threshold, *, k, num_hashes,
               log2_m, B):
    """One window of pass 1: sampled-k-mer dense build OR-merged into
    the running filter (donated — no copy per window)."""
    nb = codes.shape[0] // B

    def body(_, i):
        c = jax.lax.dynamic_slice_in_dim(codes, i * B, B, 0)
        rid = jax.lax.dynamic_slice_in_dim(ids, i * B, B, 0)
        hi, lo, valid = canonical_kmers_batch(c, k)
        keep = valid & sample_keep_mask(rid, hi.shape[1], threshold)
        blk, w = probe_words(hi, lo, num_hashes, log2_m)
        return None, (blk.reshape(-1), w.reshape(-1), keep.reshape(-1))

    _, (blks, ws, keeps) = jax.lax.scan(body, None, jnp.arange(nb))
    rows_w = bloom_rows_dense(blks.reshape(-1), ws.reshape(-1),
                              keeps.reshape(-1), log2_m)
    return rows_a | rows_w


@functools.partial(jax.jit,
                   static_argnames=("k", "num_hashes", "trust_threshold",
                                    "log2_m", "B"),
                   donate_argnames=("rows_b",))
def _p2_window(rows_a, rows_b, codes, t_table, *, k, num_hashes,
               trust_threshold, log2_m, B):
    nb = codes.shape[0] // B

    def body(_, i):
        c = jax.lax.dynamic_slice_in_dim(codes, i * B, B, 0)
        hi, lo, valid = canonical_kmers_batch(c, k)
        from ..ops.bloom import bloom_query_rows
        hits = bloom_query_rows(rows_a, hi, lo, num_hashes) & valid
        tr = trusted_mask_batch(hits, valid, t_table, k, trust_threshold)
        blk, w = probe_words(hi, lo, num_hashes, log2_m)
        return None, (blk.reshape(-1), w.reshape(-1), tr.reshape(-1))

    _, (blks, ws, trs) = jax.lax.scan(body, None, jnp.arange(nb))
    rows_w = bloom_rows_dense(blks.reshape(-1), ws.reshape(-1),
                              trs.reshape(-1), log2_m)
    return rows_b | rows_w


class _HostChunkCache:
    """Budget-gated memoization of a window source's decoded chunks.

    The round-3 BAM datapoint paid a full file re-decode per pass
    (~3.3 s/sweep at 1.5M records) because only the DEVICE window cache
    existed; this is its host twin (round-3 VERDICT next-round item 5).
    Inputs whose decoded chunks exceed the budget
    (KBBQ_STREAM_HOST_CACHE_BYTES, default 8 GB — the WGS case) drop
    the cache and re-stream every pass exactly as before, keeping the
    engine's bounded-memory promise."""

    def __init__(self, budget: int):
        self.budget = budget
        self.items: list = []
        self.nbytes = 0
        self.complete = False
        self.enabled = budget > 0

    def restart(self):
        """A fresh stream begins: drop any partial fill."""
        if not self.complete:
            self.items.clear()
            self.nbytes = 0

    def add(self, item, nbytes: int) -> None:
        if not self.enabled or self.complete:
            return
        self.nbytes += int(nbytes)
        if self.nbytes > self.budget:
            self.items.clear()
            self.enabled = False
            return
        self.items.append(item)

    def finish(self) -> None:
        if self.enabled:
            self.complete = True


def _host_cache_budget() -> int:
    import os
    return int(os.environ.get("KBBQ_STREAM_HOST_CACHE_BYTES", 8 << 30))


def _npos_bucket(n: int) -> int:
    """Pad sparse-N position lists to power-of-two buckets so window
    jits don't recompile per distinct N count."""
    b = 1024
    while b < n:
        b <<= 1
    return b


class FastqWindowSource:
    """Window source over FASTQ files: one window per streamed chunk
    (chunks are already exactly chunk_reads, so shapes stay uniform)."""

    def __init__(self, in_paths, scan, interleaved: bool,
                 chunk_reads: int):
        self.in_paths = list(in_paths)
        self.scan = scan
        self.interleaved = interleaved
        self.chunk_reads = int(chunk_reads)
        self.num_rg = len(self.in_paths)
        self.max_len = scan.max_len
        self.total_bases = scan.total_bases
        self._cache = _HostChunkCache(_host_cache_budget())

    def total_kmers(self, k: int) -> int:
        return self.scan.total_kmers(k)

    def full_chunks(self):
        """(fi, fq, arrs, ordinal) per chunk, memoized under the host
        cache budget — passes after the first stop paying the file
        read + parse + extract (pass 4 also reuses fq for the write)."""
        if self._cache.complete:
            yield from self._cache.items
            return
        self._cache.restart()

        def scanned():
            # the sequential file read + newline index runs on its own
            # prefetch stage so it overlaps the array extract below
            # (they were serialized; each is roughly half the chr20
            # decode leg)
            for fi, path in enumerate(self.in_paths):
                for fq in iter_fastq_chunks(path, self.chunk_reads):
                    yield fi, fq

        ordinal = 0
        for fi, fq in prefetch_iter(scanned(), depth=2):
            arrs = chunk_to_batch_arrays(fq, self.max_len, fi,
                                         ordinal, self.interleaved)
            item = (fi, fq, arrs, ordinal)
            self._cache.add(item, fq.buf.nbytes
                            + sum(a.nbytes for a in arrs))
            yield item
            ordinal += fq.num_reads
        self._cache.finish()

    def chunks(self):
        for fi, fq, arrs, ordinal in self.full_chunks():
            yield arrs, ordinal


def rebuffer_windows(chunk_iter, window: int):
    """Re-cut variable-size decoded chunks into fixed `window`-read
    windows (last one partial) so every full window shares one jit
    executable — BAM chunks lose a variable number of secondary/
    supplementary records per chunk, which would otherwise recompile
    the window programs per distinct padded shape."""
    pend: list = []
    have = 0
    ordinal = 0

    def emit(need: int):
        out = [[] for _ in range(5)]
        while need:
            head = pend[0]
            n0 = head[0].shape[0]
            if n0 <= need:
                for i in range(5):
                    out[i].append(head[i])
                pend.pop(0)
                need -= n0
            else:
                for i in range(5):
                    out[i].append(head[i][:need])
                pend[0] = tuple(h[need:] for h in head)
                need = 0
        return tuple(np.concatenate(c) if len(c) > 1 else c[0]
                     for c in out) + (None,)

    for arrs in chunk_iter:
        if arrs[0].shape[0] == 0:
            continue
        pend.append(tuple(arrs[:5]))
        have += arrs[0].shape[0]
        while have >= window:
            yield emit(window), ordinal
            ordinal += window
            have -= window
    if have:
        yield emit(have), ordinal


class BamWindowSource:
    """Window source over a BAM: vectorized chunk decode
    (io/bam_vec.py) re-cut into fixed-size windows."""

    def __init__(self, path: str, registry: dict, max_len: int,
                 total_bases: int, total_kmers_: int, use_oq: bool,
                 chunk_records: int, window_reads: int):
        self.path = path
        self.registry = registry
        self.num_rg = max(1, len(registry))
        self.max_len = max_len
        self.total_bases = total_bases
        self._tk = total_kmers_
        self.use_oq = use_oq
        self.chunk_records = int(chunk_records)
        self.window_reads = int(window_reads)
        self._cache = _HostChunkCache(_host_cache_budget())

    def total_kmers(self, k: int) -> int:
        return self._tk

    def raw_chunks_decoded(self):
        """(buf, offs, sizes, decoded) per raw chunk, memoized under
        the host cache budget — the BGZF inflate + record decode ran
        once per PASS before (round-3 BAM weak #4); pass 4 reuses the
        raw buf for the in-buffer qual rewrite."""
        if self._cache.complete:
            yield from self._cache.items
            return
        from ..io.bam_stream import iter_bam_raw_chunks
        from ..io.bam_vec import decode_machine_chunk
        self._cache.restart()
        _, _, chunks = iter_bam_raw_chunks(self.path, self.chunk_records)
        for buf, offs, sizes in chunks:
            dec = decode_machine_chunk(buf, offs, sizes, self.max_len,
                                       self.registry, use_oq=self.use_oq)
            item = (buf, offs, sizes, dec)
            self._cache.add(item, buf.nbytes
                            + sum(np.asarray(a).nbytes for a in dec))
            yield item
        self._cache.finish()

    def _decoded(self):
        for buf, offs, sizes, dec in self.raw_chunks_decoded():
            codes, quals, mask, rgs, seconds, _, prim = dec
            if prim.size:
                yield codes, quals, mask, rgs, seconds

    def chunks(self):
        yield from rebuffer_windows(self._decoded(), self.window_reads)


class StreamResidentEngine:
    """Per-window staging + one-jit-per-pass execution state.

    `source` provides max_len / total_bases / total_kmers(k) / num_rg
    and a re-iterable chunks() of ((codes, quals, mask, rgs, seconds,
    ids), ordinal) windows — FASTQ and BAM sources plug in above."""

    def __init__(self, source, config: RecalConfig):
        self.source = source
        self.config = config
        self.L = source.max_len
        self.B = config.batch_size
        self.num_rg = source.num_rg
        k = config.k
        self.alpha, self.coverage = config.resolve_alpha(
            source.total_bases)
        self.threshold = jnp.uint32(alpha_threshold(self.alpha))
        self.t_table = jnp.asarray(
            coverage_thresholds(self.alpha, k), dtype=jnp.int32)
        from ..oracle.bloom import check_layout_capacity
        from ..oracle.pipeline import bloom_params_for
        self.params_a, self.params_b = bloom_params_for(
            config, source.total_kmers(k), self.alpha, self.coverage)
        for p in (self.params_a, self.params_b):
            # dense windowed builds keep only packed rows on device:
            # 2^33 slots = 1 GiB packed per filter (chr20-class 2^31
            # filters are 256 MiB; human WGS needs the sharded layout)
            check_layout_capacity(
                p, 33, "single-chip streaming",
                "use --devices N --bloom-layout sharded")
        self.la = int(self.params_a.m).bit_length() - 1
        self.lb = int(self.params_b.m).bit_length() - 1
        self.rows_a = None
        self.rows_b = None
        self.tables = None
        self.recal = None
        # device window cache: packed feed is bases/4 bytes (+ small
        # lens / N-position sidecars); enable when it fits the budget
        import os as _os
        budget = _os.environ.get("KBBQ_STREAM_CACHE_BYTES")
        budget = (int(budget) if budget is not None
                  else device_budget("window_cache"))
        self._cache_enabled = (source.total_bases // 4) <= budget
        self._cache_complete = False
        self._dev_cache: list = []
        # producer-side stage timing (prefetch-thread seconds spent in
        # source decode vs host pack + device put) — diagnostic only,
        # read through the driver's stage_stats (chr20 p1 attribution)
        self.stage_stats = {"source_s": 0.0, "stage_s": 0.0}

    # ------------------------------------------------------- staging
    def _stage(self, arrs, ordinal: int):
        """Host pack + device put of one window's codes feed."""
        codes, quals, mask, rgs, seconds, _ = arrs
        n = codes.shape[0]
        npad = max(1, -(-n // self.B)) * self.B
        lens = mask.sum(axis=1).astype(np.uint16)
        if npad > n:
            codes = np.concatenate(
                [codes, np.full((npad - n, self.L), 4, np.int8)])
            lens = np.concatenate([lens, np.zeros(npad - n, np.uint16)])
        if npad == n and lens.size and int(lens.min()) == self.L:
            # uniform full-length window (the common short-read shape):
            # every code-4 byte is a real N — no [N, L] mask temporaries
            n_pos = np.flatnonzero(codes == 4).astype(np.int32)
        else:
            in_mask = (np.arange(self.L, dtype=np.int32)[None, :]
                       < lens[:, None].astype(np.int32))
            n_pos = np.flatnonzero(
                (codes == 4) & in_mask).astype(np.int32)
        cap = _npos_bucket(n_pos.size)
        flat_n = npad * self.L
        n_pos = np.concatenate(
            [n_pos, np.full(cap - n_pos.size, flat_n, np.int32)])
        dev = (jnp.asarray(_pack_quarters(codes)), jnp.asarray(n_pos),
               jnp.asarray(lens), jnp.uint32(ordinal), jnp.int32(n))
        return dev

    def _windows(self, with_host: bool = False):
        """Staged (codes, ids) device windows, decode+pack+put running
        on the prefetch thread so the device never waits on the host.

        When the packed feed fits the device window-cache budget
        (KBBQ_STREAM_CACHE_BYTES, default device_budget("window_cache")),
        pass 1's staged windows stay device-resident and later passes
        replay them — no re-decode
        and no re-ship.  Larger-than-budget inputs (the WGS case the
        streaming engine exists for) re-stream every pass as before.
        Host arrays, when a pass needs them (pass 3's covariate
        accumulation), are re-decoded on the prefetch thread and hidden
        under device compute."""
        def gen():
            if self._cache_complete:
                if with_host:
                    src = self.source.chunks()
                    for (staged, ordinal), (arrs, o2) in zip(
                            self._dev_cache, src):
                        assert o2 == ordinal
                        yield staged, arrs, ordinal
                else:
                    for staged, ordinal in self._dev_cache:
                        yield staged, None, ordinal
                return
            self._dev_cache.clear()  # drop any partial fill
            import time as _t
            # source decode runs on ITS OWN prefetch thread so it
            # overlaps the pack+put below — the two were serialized in
            # one producer thread before, and at chr20 scale each costs
            # ~29 s of the 58 s pass-1 wall (round-5 instrumentation)
            it = iter(prefetch_iter(iter(self.source.chunks()),
                                    depth=2))
            while True:
                t0 = _t.perf_counter()
                try:
                    arrs, ordinal = next(it)
                except StopIteration:
                    break
                t1 = _t.perf_counter()
                staged = self._stage(arrs, ordinal)
                t2 = _t.perf_counter()
                self.stage_stats["source_s"] += t1 - t0
                self.stage_stats["stage_s"] += t2 - t1
                if self._cache_enabled:
                    self._dev_cache.append((staged, ordinal))
                yield staged, (arrs if with_host else None), ordinal
            if self._cache_enabled:
                self._cache_complete = True
        for staged, arrs, ordinal in prefetch_iter(gen(), depth=2):
            packed, n_pos, lens, off, nreal = staged
            codes, ids = _expand_window(packed, n_pos, lens, off, nreal,
                                        L=self.L)
            yield codes, ids, arrs, ordinal

    # --------------------------------------------------------- passes
    def run_pass1(self):
        k, h = self.config.k, self.config.num_hashes
        rows = jnp.zeros(self.params_a.m // 32, jnp.uint32)
        for codes, ids, _, _ in self._windows():
            rows = _p1_window(rows, codes, ids, self.threshold, k=k,
                              num_hashes=h, log2_m=self.la, B=self.B)
        jax.block_until_ready(rows)       # pass-boundary sync
        self.rows_a = rows

    def run_pass2(self):
        k, h = self.config.k, self.config.num_hashes
        rows = jnp.zeros(self.params_b.m // 32, jnp.uint32)
        for codes, _, _, _ in self._windows():
            rows = _p2_window(self.rows_a, rows, codes, self.t_table,
                              k=k, num_hashes=h,
                              trust_threshold=self.config.trust_threshold,
                              log2_m=self.lb, B=self.B)
        jax.block_until_ready(rows)
        self.rows_b = rows

    def run_pass3(self):
        k, h = self.config.k, self.config.num_hashes
        wc = self.config.walk_chunk or WALK_CHUNK
        tables = CovariateTables(self.num_rg, self.L)
        L = self.L

        def fetch_accum(enc_dev, bits_dev, arrs):
            codes, quals, mask, rgs, seconds, _ = arrs
            n = codes.shape[0]
            enc = np.asarray(enc_dev)
            cnt = int(enc[0])
            cap = enc.shape[0] - 1
            if cnt <= cap:
                err_idx = enc[1:1 + cnt].astype(np.int64)
            else:
                bits = np.asarray(bits_dev)
                err_idx = np.flatnonzero(np.unpackbits(
                    bits, count=bits.size * 8)).astype(np.int64)
            err_idx = err_idx[err_idx < n * L]
            accumulate_covariates_host(codes, quals, mask, rgs, seconds,
                                       err_idx, self.num_rg, L,
                                       tables=tables)

        ex = ThreadPoolExecutor(1)
        futs = []
        for codes, _, arrs, _ in self._windows(with_host=True):
            err_g = _pass3_walks(self.rows_b, codes, k=k, num_hashes=h,
                                 ext_cap=self.config.ext_cap, B=self.B,
                                 walk_chunk=wc)
            n_flat = codes.shape[0] * L
            enc_g = _sparse_error_idx(err_g, cap=sparse_err_cap(n_flat))
            bits_g = _pack_error_bits(err_g)
            futs.append(ex.submit(fetch_accum, enc_g, bits_g, arrs))
        for f in futs:
            f.result()
        ex.shutdown(wait=False)
        self.tables = tables

    def compute_recal_table(self):
        self.recal = build_recal_table(self.tables)
        return self.recal


def recalibrate_fastq_stream_resident(
        in_paths, out_paths, config: RecalConfig,
        checkpoint_dir: str | None = None,
        interleaved: bool = False,
        chunk_reads: int = DEFAULT_CHUNK_READS,
        timings: dict | None = None,
        report_out: str | None = None,
        apply_report: str | None = None) -> dict:
    """FASTQ -> FASTQ streaming recalibration, resident-window engine.

    Same output-path semantics, checkpoints, and pass-4 chunk-offset
    resume as pipeline/streaming.py::recalibrate_fastq_streaming —
    byte-identical output to the in-RAM pipelines for any chunk size.
    report_out/apply_report: GATK-report emission / ApplyBQSR-equivalent
    pass-4-only mode (P9), matching pipeline/recalibrate.py semantics.
    """
    import time as _time
    t_last = [_time.time()]
    _stage_last = [0.0, 0.0]

    if isinstance(in_paths, (str, bytes)):
        in_paths = [in_paths]
    scan = scan_fastq_files(in_paths, config.k, chunk_reads)
    src = FastqWindowSource(in_paths, scan, interleaved, chunk_reads)
    eng = StreamResidentEngine(src, config)

    def _mark(name):                      # rebind now that eng exists
        if timings is not None:
            now = _time.time()
            timings[name] = round(now - t_last[0], 3)
            t_last[0] = now
            ss = eng.stage_stats
            timings[name + "_src"] = round(
                ss["source_s"] - _stage_last[0], 3)
            timings[name + "_put"] = round(
                ss["stage_s"] - _stage_last[1], 3)
            _stage_last[0] = ss["source_s"]
            _stage_last[1] = ss["stage_s"]

    _mark("scan")

    ckpt = None
    if checkpoint_dir:
        from ..state.checkpoint import Checkpoint, stream_fingerprint
        ckpt = Checkpoint(checkpoint_dir)
        fp = stream_fingerprint(config, in_paths, scan)
        # pass-4 chunk-offset resume counts in CHUNK units, and the
        # pairing mode changes covariates — pin both (self-review r5)
        fp["chunk_reads"] = int(chunk_reads)
        fp["interleaved"] = bool(interleaved)
        ckpt.check_fingerprint(fp)

    if apply_report is not None:
        from ..gatk_report import read_gatk_report, recal_table_from_report
        recal = recal_table_from_report(
            read_gatk_report(apply_report),
            [str(p) for p in in_paths], eng.L)
        _mark("apply-table")
    else:
        rows = ckpt.load_array("rows_a") if ckpt else None
        if rows is not None:
            eng.rows_a = jnp.asarray(rows)
        else:
            eng.run_pass1()
            if ckpt:
                ckpt.save_array("rows_a", eng.rows_a)
        _mark("pass1")

        rows = ckpt.load_array("rows_b") if ckpt else None
        if rows is not None:
            eng.rows_b = jnp.asarray(rows)
        else:
            eng.run_pass2()
            if ckpt:
                ckpt.save_array("rows_b", eng.rows_b)
        _mark("pass2")

        loaded = ckpt.load_covariates() if ckpt else None
        if loaded is not None:
            eng.tables = loaded
        else:
            eng.run_pass3()
            if ckpt:
                ckpt.save_covariates(eng.tables)
        _mark("pass3")

        recal = eng.compute_recal_table()
        if report_out is not None:
            from ..gatk_report import write_gatk_report
            write_gatk_report(eng.tables, [str(p) for p in in_paths],
                              report_out)
        _mark("deltas")

    # ------------------------------------------------------- pass 4
    # host-side gather per chunk (the recal table is tiny; no device
    # traffic at all) + incremental write with chunk-offset resume —
    # same sink semantics as pipeline/streaming.py
    from ..io.fastq import is_gz_path, open_fastq_sink

    single_sink = not isinstance(out_paths, (list, tuple))
    opened: list = []
    done_chunks = 0
    meta = ckpt.load_meta() if ckpt else {}
    p4 = meta.get("pass4")
    # byte-offset resume needs a seekable plain sink; a .gz sink is a
    # compressed stream, so its pass 4 restarts from chunk 0 instead
    resumable = (ckpt is not None and single_sink
                 and isinstance(out_paths, (str, bytes))
                 and not is_gz_path(out_paths))
    if resumable and p4:
        done_chunks = int(p4["chunks"])

    if single_sink:
        if isinstance(out_paths, (str, bytes)):
            if done_chunks:
                f = open(out_paths, "r+b")
                f.truncate(int(p4["bytes"]))
                f.seek(int(p4["bytes"]))
            else:
                f = open_fastq_sink(out_paths)
            opened.append(f)
            sinks = [f]
        else:
            sinks = [out_paths]
    else:
        if len(out_paths) != len(in_paths):
            raise ValueError("need one output per input (or one sink)")
        sinks = []
        for o in out_paths:
            if isinstance(o, (str, bytes)):
                f = open_fastq_sink(o)
                opened.append(f)
                sinks.append(f)
            else:
                sinks.append(o)

    chunk_idx = 0
    # pass-4 pipeline: RENDERS (buffer copy + native qual scatter) run
    # on a 2-worker pool while the single write worker consumes their
    # futures in submission order — ordered sink writes, parallel
    # renders, and both overlap the next chunk's gather (round-5
    # instrumentation: gather is ~4 s of a ~29 s chr20 pass 4; the
    # serialized render+write worker was the rest).  With checkpointing
    # the write stays synchronous — the resume bookkeeping (bytes
    # written so far) must be exact.
    from ..io.fastq import render_fastq_with_quals
    import os as _os
    wex = ThreadPoolExecutor(1)
    # 1 render worker on small hosts (a 4-core box already runs main +
    # prefetch + writer threads); wider on larger hosts
    rex = ThreadPoolExecutor(2 if (_os.cpu_count() or 4) > 4 else 1)
    pending: list = []
    try:
        p4_gather = 0.0
        for fi, fq, arrs, ordinal in prefetch_iter(src.full_chunks(),
                                                   depth=2):
            if chunk_idx < done_chunks:
                chunk_idx += 1
                continue
            codes, quals, mask, rgs, seconds, _ = arrs
            _tg = _time.perf_counter()
            nq = apply_recal_table_host(recal, codes, quals, mask, rgs,
                                        seconds)
            p4_gather += _time.perf_counter() - _tg
            sink = sinks[0] if single_sink else sinks[fi]
            if resumable:
                write_fastq_with_quals(fq, nq, mask, sink)
                sink.flush()
                meta = ckpt.load_meta()
                meta["pass4"] = {"chunks": chunk_idx + 1,
                                 "bytes": sink.tell()}
                ckpt.save_meta(meta)
            else:
                rfut = rex.submit(render_fastq_with_quals, fq, nq, mask)
                pending.append(wex.submit(
                    lambda f=rfut, s=sink: s.write(f.result())))
            chunk_idx += 1
    finally:
        for f in pending:   # drain queued writes before closing sinks
            f.result()
        wex.shutdown(wait=False)
        rex.shutdown(wait=False)
        for f in opened:
            f.close()
    _mark("pass4")
    if timings is not None:
        timings["pass4_gather"] = round(p4_gather, 3)

    return {"num_reads": scan.num_reads,
            "total_bases": scan.total_bases,
            "read_groups": eng.num_rg,
            "streamed": True,
            "engine": "resident-window",
            "chunks": chunk_idx}


def recalibrate_bam_stream_resident(
        in_path: str, out_path, config: RecalConfig,
        use_oq: bool = False, set_oq: bool = False,
        checkpoint_dir: str | None = None,
        chunk_records: int | None = None,
        window_reads: int | None = None,
        timings: dict | None = None,
        report_out: str | None = None,
        apply_report: str | None = None) -> dict:
    """BAM -> BAM streaming recalibration, resident-window engine.

    The BAM twin of recalibrate_fastq_stream_resident: one jit per pass
    per fixed-size read window (vectorized chunk decode feeding the
    rebuffering window source), then a device-free pass 4 — host recal
    gather (ops/recal.py twin) + in-buffer qual rewrite + incremental
    BGZF write.  Byte-identical to the per-batch BAM driver
    (pipeline/bam.py); tests assert it.
    """
    import time as _time

    from ..io.bam_stream import (
        DEFAULT_CHUNK_RECORDS,
        BamStreamWriter,
        iter_bam_raw_chunks,
    )
    from ..io.bam_vec import rewrite_quals_chunk
    from .bam import scan_bam

    t_last = [_time.time()]

    def _mark(name):
        if timings is not None:
            now = _time.time()
            timings[name] = round(now - t_last[0], 3)
            t_last[0] = now

    chunk_records = chunk_records or DEFAULT_CHUNK_RECORDS
    window_reads = window_reads or DEFAULT_CHUNK_READS
    k = config.k
    n, bases, tk, max_len, registry = scan_bam(in_path, k, use_oq,
                                               chunk_records)
    src = BamWindowSource(in_path, registry, max_len, bases, tk, use_oq,
                          chunk_records, window_reads)
    eng = StreamResidentEngine(src, config)
    _mark("scan")

    ckpt = None
    if checkpoint_dir:
        from ..state.checkpoint import Checkpoint, effective_ext_cap
        ckpt = Checkpoint(checkpoint_dir)
        fp = {"k": k, "alpha": config.alpha, "coverage": config.coverage,
              "genome_length": config.genome_length,
              "num_hashes": config.num_hashes,
              "trust_threshold": config.trust_threshold,
              "ext_cap": effective_ext_cap(config), "use_oq": use_oq,
              "num_reads": n, "total_bases": bases, "bam": True}
        ckpt.check_fingerprint(fp)

    if apply_report is not None:
        from ..gatk_report import read_gatk_report, recal_table_from_report
        from .bam import _registry_names
        recal = recal_table_from_report(
            read_gatk_report(apply_report), _registry_names(registry),
            eng.L)
        _mark("apply-table")
    else:
        rows = ckpt.load_array("rows_a") if ckpt else None
        if rows is not None:
            eng.rows_a = jnp.asarray(rows)
        else:
            eng.run_pass1()
            if ckpt:
                ckpt.save_array("rows_a", eng.rows_a)
        _mark("pass1")

        rows = ckpt.load_array("rows_b") if ckpt else None
        if rows is not None:
            eng.rows_b = jnp.asarray(rows)
        else:
            eng.run_pass2()
            if ckpt:
                ckpt.save_array("rows_b", eng.rows_b)
        _mark("pass2")

        loaded = ckpt.load_covariates() if ckpt else None
        if loaded is not None:
            eng.tables = loaded
        else:
            eng.run_pass3()
            if ckpt:
                ckpt.save_covariates(eng.tables)
        _mark("pass3")

        recal = eng.compute_recal_table()
        if report_out is not None:
            from ..gatk_report import write_gatk_report
            from .bam import _registry_names
            write_gatk_report(eng.tables, _registry_names(registry),
                              report_out)
        _mark("deltas")

    # pass 4: cached-or-streamed raw chunks + host gather + in-buffer
    # rewrite; the whole chunk (secondary/supplementary included)
    # streams out verbatim.  The rewrite + BGZF deflate run
    # write-behind on a worker thread, overlapping the next chunk's
    # gather (and decode, when the host cache is over budget).
    header_text, refs, _ = iter_bam_raw_chunks(in_path, 1)
    writer = BamStreamWriter(out_path, header_text, refs)
    # rewrite (in-buffer qual scatter) runs on its own pool while the
    # single write worker consumes the futures in order — the BGZF
    # deflate (itself multithreaded) overlaps the next chunk's rewrite
    # instead of serializing behind it
    import os as _os
    wex = ThreadPoolExecutor(1)
    rex = ThreadPoolExecutor(2 if (_os.cpu_count() or 4) > 4 else 1)
    pending: list = []

    try:
        for buf, offs, sizes, dec in prefetch_iter(
                src.raw_chunks_decoded(), depth=2):
            codes, quals, mask, rgs, seconds, lens, prim = dec
            if prim.size:
                nq = apply_recal_table_host(recal, codes, quals, mask,
                                            rgs, seconds)
                rfut = rex.submit(rewrite_quals_chunk, buf, offs, sizes,
                                  prim, lens, nq, set_oq=set_oq)
                pending.append(wex.submit(
                    lambda f=rfut: writer.write_raw(f.result())))
            else:
                pending.append(wex.submit(writer.write_raw, buf))
    finally:
        for f in pending:   # drain queued writes before closing
            f.result()
        wex.shutdown(wait=False)
        rex.shutdown(wait=False)
        writer.close()
    _mark("pass4")

    return {"num_reads": n, "total_bases": bases,
            "read_groups": eng.num_rg, "streamed": True,
            "engine": "resident-window"}
