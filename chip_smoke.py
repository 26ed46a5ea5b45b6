"""End-to-end smoke of kbbq-tpu's four-pass recalibrate on one GPU.

Run from the root of a checkout, on a machine with an NVIDIA GPU:

    python chip_smoke.py                # one card, all phases
    python chip_smoke.py --four-cards   # only the 4-card path + its check

Phases (one process holds the card; everything that runs on the CPU
backend runs in a child with JAX_PLATFORMS=cpu, so it never opens it):

1. device     — JAX version, platform, device kind and count, compile
                cache, the card's name and power limit (nvidia-smi), the
                native host codec.  Not a GPU, or no codec: exit 2.
2. ops        — every device op of the main path at production widths
                (B=8192, L=150, k=32, the E. coli run's 2^28-slot
                filters), bit-for-bit against its NumPy twin in
                kbbq_tpu/oracle (the per-read trusted-mask and walk
                oracles on a seeded 256-row sample),
                with compile time, warm time and memory analysis.
3. golden     — tests/data/midscale_golden.npz (the oracle's output for
                20k production-config reads) through the resident,
                streamed-FASTQ and BAM engines: byte-identical.
4. full width — `kbbq_tpu.cli.main.main` on a generated E. coli-scale
                run (4.6 Mb genome, 50x, 2x150 bp: 1,533,334 reads) as
                FASTQ in RAM, FASTQ --stream and BAM --stream --set-oq,
                each cold then warm; the three routes' qualities must be
                identical.  The same three routes, and the batched
                engine (--checkpoint-dir: covariates and pass 4 on the
                card too), on the 400k-read bench.py dataset must equal
                the CPU-backend golden, computed in the child meanwhile.

--four-cards runs `run_pipeline(devices=4)` in the replicated and the
sharded Bloom layout on the midscale golden and the full-width dataset,
each against the one-card output, and prints where the filters live.

The last line of stdout is {"ok": true, "device": {...}}; any failed
phase raises, so the script exits non-zero without printing it.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "data", "midscale_golden.npz")

# the E. coli deployment (BASELINE config 2/3): 4.6 Mb genome at 50x
# with 2x150 bp reads, k=32, batch 8192 (genome = reads x 150 / 50, as
# in bench.py)
COVERAGE = 50.0
READ_LEN = 150
K = 32
BATCH = 8192
ECOLI_READS = 1_533_334            # genome x coverage / read length, even
BENCH_READS = 400_000              # bench.py's dataset (CPU golden)

_T0 = time.time()


def log(msg: str) -> None:
    print(f"[smoke {time.time() - _T0:8.1f}s] {msg}", flush=True)


class SmokeFailure(AssertionError):
    """A phase's check failed."""


def check(cond, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


# ------------------------------------------------------------ phase 1

def phase_device() -> dict:
    """Print what runs where; the device info, or SystemExit(2) when JAX
    finds no GPU or the native host codec did not load."""
    import jax

    from kbbq_tpu.io import native_lib
    from kbbq_tpu.utils.compile_cache import enable_compile_cache
    from kbbq_tpu.utils.device import (device_info,
                                       gpu_name_and_power_limit,
                                       require_gpu)

    cache = enable_compile_cache()
    info = device_info()
    log(f"jax {jax.__version__}: platform={info['platform']} "
        f"kind={info['kind']!r} count={info['count']} cache={cache}")
    require_gpu("chip_smoke.py")
    cards = gpu_name_and_power_limit().splitlines()
    print("\n".join(f"card: {c}" for c in cards), flush=True)
    card = cards[0] if len(set(cards)) == 1 else "; ".join(cards)
    if len(cards) > 1:
        card += f" (x{len(cards)})"
    lib = native_lib.get_lib()
    log(f"native host codec: {'loaded' if lib is not None else 'MISSING'}")
    if lib is None:
        print("chip_smoke: the native codec (kbbq_tpu/io/native) did not "
              "build or load", file=sys.stderr)
        raise SystemExit(2)
    info["card"] = card
    return info


# ------------------------------------------------------------ phase 2

def _timed(name: str, fn, *args):
    """Compile `fn` for `args`, run it warm three times; print compile
    time, best/median warm time and the compiled memory analysis.
    Returns the output on the host."""
    import jax
    import numpy as np

    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    t_compile = time.perf_counter() - t0
    out = jax.block_until_ready(compiled(*args))
    warm = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = jax.block_until_ready(compiled(*args))
        warm.append(time.perf_counter() - t0)
    mem = compiled.memory_analysis()
    mem_s = "n/a" if mem is None else (
        f"args={mem.argument_size_in_bytes} out={mem.output_size_in_bytes}"
        f" temp={mem.temp_size_in_bytes}")
    log(f"op {name}: compile {t_compile:.3f}s, warm best "
        f"{min(warm) * 1e3:.3f} ms median {np.median(warm) * 1e3:.3f} ms,"
        f" memory {mem_s}")
    return jax.device_get(out)


def _pack_rows(slots) -> "np.ndarray":
    """NumPy twin of ops/bloom.py::bloom_rows: word b bit j =
    slots[32 b + j]."""
    import numpy as np
    bits = slots.reshape(-1, 32).astype(np.uint32)
    return np.bitwise_or.reduce(
        bits << np.arange(32, dtype=np.uint32), axis=1).astype(np.uint32)


def phase_ops(B: int = BATCH, L: int = READ_LEN, k: int = K,
              log2_m_a: int = 28, log2_m_b: int = 28, sample: int = 256,
              walk_chunk: int | None = None, seed: int = 0) -> dict:
    """Every main-path device op at [B, L] with 2^log2_m-slot filters,
    bit-for-bit against its oracle twin.  One batch at 50x over a
    B*L/50-base genome, so the filters hold real k-mers and the walks
    real anchors and errors.  Returns {op: True} for the ops checked."""
    import jax.numpy as jnp
    import numpy as np

    from kbbq_tpu.constants import DEFAULT_NUM_HASHES, NUM_Q
    from kbbq_tpu.oracle import BloomParams, CovariateTables, OracleBloom
    from kbbq_tpu.oracle import accumulate_read
    from kbbq_tpu.oracle import kmers as okm
    from kbbq_tpu.oracle import lighter as olight
    from kbbq_tpu.oracle.covariate import (compute_skips, cycle_indices,
                                           dinuc_indices)
    from kbbq_tpu.oracle.gatk import build_recal_table
    from kbbq_tpu.ops.bloom import (bloom_insert_rows, bloom_query_rows,
                                    bloom_rows, bloom_rows_dense,
                                    probe_word, probe_words)
    from kbbq_tpu.ops.covariate import (accumulate_covariates,
                                        new_covariate_state)
    from kbbq_tpu.ops.inference import (WALK_CHUNK, _permute_rows_mxu,
                                        infer_errors_scheduled)
    from kbbq_tpu.ops.kmers import (canonical_kmers_batch, kmer_hashes,
                                    sample_keep_mask)
    from kbbq_tpu.ops.recal import apply_recal_table
    from kbbq_tpu.ops.trusted import trusted_mask_batch
    from kbbq_tpu.pipeline import RecalConfig
    from kbbq_tpu.pipeline.resident import (SAMPLE_PREFIX_SLACK,
                                            _dense_finish)
    from kbbq_tpu.utils.synth import make_arrays_fast

    h = DEFAULT_NUM_HASHES
    wc = walk_chunk or WALK_CHUNK
    n = L - k + 1
    arrays, _ = make_arrays_fast(
        genome_len=max(1000, int(B * L / COVERAGE)), read_len=L,
        num_reads=B, error_rate=0.005, seed=seed, num_rg=2)
    alpha, _ = RecalConfig(k=k, coverage=COVERAGE).resolve_alpha(B * L)
    codes_h = arrays.codes
    codes = jnp.asarray(codes_h)
    ids = jnp.arange(B, dtype=jnp.uint32)
    thr = jnp.uint32(okm.alpha_threshold(alpha))
    done = {}

    # -- canonical k-mer packing + pass-1 sampling
    hi, lo, valid, keep = _timed(
        "canonical_kmers_batch+sample_keep_mask",
        lambda c, i, t: canonical_kmers_batch(c, k)
        + (sample_keep_mask(i, n, t),), codes, ids, thr)
    for b in range(B):
        ohi, olo, ov = okm.canonical_kmers(codes_h[b], k)
        check((valid[b] == ov).all()
              and (hi[b][ov] == ohi[ov]).all()
              and (lo[b][ov] == olo[ov]).all(), f"k-mers, read {b}")
        check((keep[b] == (okm.sample_hash(
            np.uint32(b), np.arange(n, dtype=np.uint32))
            <= okm.alpha_threshold(alpha))).all(), f"sample, read {b}")
    done["kmers"] = True
    keep = keep & valid

    # -- filter A: row insert (scatter-max), bf16 row pack, dense build
    pa = BloomParams(log2_m=log2_m_a, num_hashes=h)
    ob_a = OracleBloom(pa)
    ob_a.insert(hi, lo, mask=keep)
    want_rows_a = _pack_rows(ob_a.slots)
    jhi, jlo = jnp.asarray(hi), jnp.asarray(lo)
    slots_a = _timed(
        "bloom_insert_rows (filter A)",
        lambda s, a, b_, m: bloom_insert_rows(s, a, b_, m, h),
        jnp.zeros(pa.m, jnp.uint8), jhi, jlo, jnp.asarray(keep))
    check((slots_a == ob_a.slots).all(), "bloom_insert_rows bytes")
    rows_a = _timed("bloom_rows (bf16 pack)", bloom_rows,
                    jnp.asarray(slots_a))
    check((rows_a == want_rows_a).all(), "bloom_rows words")
    blk, w = probe_words(jhi, jlo, h, log2_m_a)
    dense = _timed(
        "bloom_rows_dense",
        lambda b_, w_, m: bloom_rows_dense(b_, w_, m, log2_m_a),
        blk.reshape(-1), w.reshape(-1), jnp.asarray(keep).reshape(-1))
    check((dense == want_rows_a).all(), "bloom_rows_dense words")
    h1, h2 = kmer_hashes(jhi, jlo)
    wv = jnp.where(jnp.asarray(valid), probe_word(h2, h), jnp.uint32(0))
    Ns = B * n
    P = min(Ns, int(Ns * alpha * SAMPLE_PREFIX_SLACK) + 4096)
    fin, cnt = _timed(
        "resident._dense_finish (sampled prefix)",
        lambda a, b_, c: _dense_finish((a,), (b_,), (c,), log2_m=log2_m_a,
                                       prefix=P),
        h1.reshape(-1), wv.reshape(-1), jnp.asarray(keep).reshape(-1))
    check(int(cnt) <= P and (fin == want_rows_a).all(),
          "_dense_finish words")
    done["bloom_build"] = True

    # -- query filter A + trusted mask
    hits = _timed(
        "bloom_query_rows (filter A)",
        lambda r, a, b_: bloom_query_rows(r, a, b_, h),
        jnp.asarray(rows_a), jhi, jlo) & valid
    check((hits == (ob_a.query(hi, lo) & valid)).all(), "bloom_query_rows")
    t_table = jnp.asarray(olight.coverage_thresholds(alpha, k), jnp.int32)
    tr = _timed("trusted_mask_batch",
                lambda a, v, t: trusted_mask_batch(a, v, t, k),
                jnp.asarray(hits), jnp.asarray(valid), t_table)
    # the two per-read Python oracles (trusted mask, walk) run on a
    # seeded sample of rows; every other op is checked on the whole batch
    rows = np.sort(np.random.default_rng(seed).choice(
        B, size=min(sample, B), replace=False))
    for b in rows:
        check((tr[b] == olight.trusted_kmer_mask(
            codes_h[b], k, ob_a, alpha)).all(), f"trusted mask, read {b}")
    done["trusted"] = True

    # -- filter B, then the scheduled walks (oracle on a seeded sample)
    pb = BloomParams(log2_m=log2_m_b, num_hashes=h)
    ob_b = OracleBloom(pb)
    ob_b.insert(hi, lo, mask=tr)
    rows_b = jnp.asarray(bloom_rows(bloom_insert_rows(
        jnp.zeros(pb.m, jnp.uint8), jhi, jlo, jnp.asarray(tr), h)))
    check((np.asarray(rows_b) == _pack_rows(ob_b.slots)).all(),
          "filter B words")
    errors = _timed(
        "infer_errors_scheduled",
        lambda r, c: infer_errors_scheduled(r, c, k, h, chunk=wc),
        rows_b, codes)
    for b in rows:
        check((errors[b] == olight.infer_read_errors(
            codes_h[b], k, ob_b)).all(), f"walk, read {b}")
    log(f"walks: {int(errors.sum())} errors marked in {B} reads; "
        f"{len(rows)} sampled rows match the oracle walk")
    done["walk"] = True

    # -- the walk's permutation: one-hot matmul vs jnp.take, same shape
    order = jnp.asarray(np.random.default_rng(seed + 1).permutation(2 * B)
                        .astype(np.int32))
    payload = jnp.concatenate([codes, codes[:, ::-1]], 0)
    flags = payload == 0

    def onehot_perm(o, x, f):
        oh = (jnp.arange(2 * B, dtype=jnp.int32)[None, :]
              == o[:, None]).astype(jnp.bfloat16)
        return _permute_rows_mxu(oh, x), _permute_rows_mxu(oh, f)

    mx = _timed("_permute_rows_mxu [2B, 2B] one-hot (int8 + bool)",
                onehot_perm, order, payload, flags)
    tk = _timed("jnp.take rows (int8 + bool)",
                lambda o, x, f: (jnp.take(x, o, axis=0),
                                 jnp.take(f, o, axis=0)),
                order, payload, flags)
    check(all((a == b_).all() for a, b_ in zip(mx, tk)),
          "one-hot permutation vs take")
    done["permute"] = True

    # -- covariate histograms (int8 one-hot einsums) + pass-4 gather
    num_rg = int(arrays.rgs.max()) + 1
    dev_args = [jnp.asarray(a) for a in (arrays.quals, arrays.mask,
                                         arrays.rgs, arrays.seconds)]
    cov = _timed(
        "accumulate_covariates",
        lambda c, q, m, r, s, e: accumulate_covariates(
            new_covariate_state(num_rg, L), c, q, m, r, s, e),
        codes, *dev_args, jnp.asarray(errors))
    tables = CovariateTables(num_rg, L)
    for b in range(B):
        accumulate_read(tables, codes_h[b], arrays.quals[b], errors[b],
                        int(arrays.rgs[b]), bool(arrays.seconds[b]))
    for name in ("cyc_total", "cyc_errors", "din_total", "din_errors"):
        check((cov[name] == getattr(tables, name)).all(),
              f"covariates {name}")
    done["covariates"] = True
    recal = build_recal_table(tables)
    nq = _timed("apply_recal_table", apply_recal_table, jnp.asarray(recal),
                codes, *dev_args)
    for b in range(B):
        c = codes_h[b].astype(np.int64)
        q = arrays.quals[b].astype(np.int64)
        want = recal[arrays.rgs[b], np.clip(q, 0, NUM_Q - 1),
                     cycle_indices(L, bool(arrays.seconds[b])),
                     dinuc_indices(c)].astype(np.int64)
        want = np.where(compute_skips(c, q), q, want)
        check((nq[b] == want).all(), f"recal gather, read {b}")
    done["recal"] = True
    return done


# ------------------------------------------------------------ phase 3

def midscale_dataset():
    """(arrays, cfg, golden quals, dataset) for midscale_golden.npz."""
    import numpy as np

    from kbbq_tpu.io.batcher import ReadArrays
    from kbbq_tpu.pipeline import RecalConfig
    from kbbq_tpu.utils.synth import make_dataset

    z = np.load(GOLDEN)
    seed, gl, rl, cov, k, nrg = (int(v) for v in z["meta"])
    ds = make_dataset(genome_len=gl, read_len=rl, coverage=float(cov),
                      error_rate=0.01, seed=seed, num_rg=nrg, paired=True,
                      n_rate=0.002)
    codes = np.stack([np.asarray(c) for c in ds.codes])
    quals = np.stack([np.asarray(q).astype(np.int8) for q in ds.quals])
    arrays = ReadArrays(codes, quals, np.ones(codes.shape, bool),
                        np.asarray(ds.rgs, np.int32),
                        np.asarray(ds.seconds, bool))
    cfg = RecalConfig(k=k, coverage=float(cov), batch_size=2048)
    return arrays, cfg, z["quals"], ds


@contextlib.contextmanager
def _round_robin_read_groups(num_rg: int):
    """A FASTQ file is one read group; the midscale golden has `num_rg`
    interleaved round-robin by ordinal.  Within this block the streamed
    FASTQ engine assigns them so (decode, windows and passes unchanged)."""
    from kbbq_tpu.pipeline import stream_resident as sr

    base = sr.FastqWindowSource

    class RoundRobin(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.num_rg = num_rg

        def full_chunks(self):
            for fi, fq, arrs, ordinal in super().full_chunks():
                c, q, m, _, s, ids = arrs
                yield fi, fq, (c, q, m, (ids % num_rg).astype("int32"),
                               s, ids), ordinal

    sr.FastqWindowSource = RoundRobin
    try:
        yield
    finally:
        sr.FastqWindowSource = base


def fastq_quals(path: str, max_len: int):
    from kbbq_tpu.io.fastq import extract_padded_arrays, read_fastq
    return extract_padded_arrays(read_fastq(path), max_len)[1]


def bam_quals(path: str, k: int):
    """QUAL fields of a BAM's primary records, in machine (read) order."""
    import numpy as np

    from kbbq_tpu.io.bam_stream import iter_bam_raw_chunks
    from kbbq_tpu.io.bam_vec import decode_machine_chunk
    from kbbq_tpu.pipeline.bam import scan_bam

    _, _, _, max_len, registry = scan_bam(path, k)
    _, _, chunks = iter_bam_raw_chunks(path, 65536)
    parts = [decode_machine_chunk(buf, offs, sizes, max_len, registry)[1]
             for buf, offs, sizes in chunks]
    return np.concatenate(parts)


def phase_golden(workdir: str, chunk: int = 4096, dataset=None) -> dict:
    """The three single-card engines against the oracle golden
    (`dataset`: midscale_dataset()'s tuple; default the midscale one)."""
    import numpy as np

    import bench
    from kbbq_tpu.io.bam import BamFile, build_record, serialize_bam
    from kbbq_tpu.pipeline.bam import recalibrate_bam_streaming
    from kbbq_tpu.pipeline.recalibrate import run_pipeline
    from kbbq_tpu.pipeline.stream_resident import \
        recalibrate_fastq_stream_resident

    arrays, cfg, want, ds = dataset or midscale_dataset()
    L = arrays.max_len
    nrg = int(arrays.rgs.max()) + 1
    res = {}
    t0 = time.time()
    got = np.asarray(run_pipeline(arrays, cfg), np.int8)
    res["resident"] = bool(np.array_equal(got, want))
    log(f"golden resident: {res['resident']} ({time.time() - t0:.2f}s)")

    fq = os.path.join(workdir, "midscale.fq")
    out = os.path.join(workdir, "midscale.out.fq")
    bench._write_synth_fastq(arrays, fq)
    t0 = time.time()
    with _round_robin_read_groups(nrg):
        recalibrate_fastq_stream_resident([fq], out, cfg, interleaved=True,
                                          chunk_reads=chunk)
    res["streamed_fastq"] = bool(np.array_equal(fastq_quals(out, L), want))
    log(f"golden streamed FASTQ: {res['streamed_fastq']} "
        f"({time.time() - t0:.2f}s)")

    recs = [build_record(
        f"r{i}", arrays.codes[i], arrays.quals[i].astype(np.uint8),
        flag=0x4 | ((0x1 | 0x80) if ds.seconds[i] else 0x1),
        rg=f"g{ds.rgs[i]}") for i in range(arrays.num_reads)]
    bam = os.path.join(workdir, "midscale.bam")
    header = "@HD\tVN:1.6\n" + "".join(f"@RG\tID:g{i}\n"
                                       for i in range(nrg))
    with open(bam, "wb") as f:
        f.write(serialize_bam(BamFile(header, [], recs), compress=True))
    out_bam = os.path.join(workdir, "midscale.out.bam")
    t0 = time.time()
    recalibrate_bam_streaming(bam, out_bam, cfg, chunk_records=chunk)
    res["bam"] = bool(np.array_equal(bam_quals(out_bam, cfg.k), want))
    log(f"golden BAM: {res['bam']} ({time.time() - t0:.2f}s)")
    check(all(res.values()), f"midscale golden mismatch: {res}")
    return res


# ------------------------------------------------------------ phase 4

@contextlib.contextmanager
def engine_timings(sink: dict):
    """Collect the per-pass `timings` the engines fill when given a dict
    (the CLI passes none): wraps the three single-card engine entry
    points, which the drivers import at call time."""
    from kbbq_tpu.pipeline import resident, stream_resident

    saved = []
    for mod, name in ((resident, "recalibrate_arrays_resident"),
                      (stream_resident, "recalibrate_fastq_stream_resident"),
                      (stream_resident, "recalibrate_bam_stream_resident")):
        orig = getattr(mod, name)

        @functools.wraps(orig)
        def wrapper(*a, _orig=orig, _name=name, **kw):
            kw["timings"] = t = {}
            out = _orig(*a, **kw)
            sink[_name] = t
            return out

        saved.append((mod, name, orig))
        setattr(mod, name, wrapper)
    try:
        yield sink
    finally:
        for mod, name, orig in saved:
            setattr(mod, name, orig)


def make_run_files(workdir: str, num_reads: int, tag: str):
    """bench.py's dataset at `num_reads`, as FASTQ and as BAM."""
    import bench
    from kbbq_tpu.utils.synth import make_arrays_fast

    genome = max(1000, int(num_reads * READ_LEN / COVERAGE))
    arrays, _ = make_arrays_fast(genome_len=genome, read_len=READ_LEN,
                                 num_reads=num_reads, error_rate=0.005,
                                 seed=0)
    fq = os.path.join(workdir, f"{tag}.fq")
    bam = os.path.join(workdir, f"{tag}.bam")
    bench._write_synth_fastq(arrays, fq)
    bench._write_synth_bam(arrays, bam)
    return arrays, fq, bam


# the CLI's single-card routes: FASTQ in RAM (resident engine), FASTQ
# --stream (streamed engine), BAM --stream --set-oq (streamed BAM
# engine); with --checkpoint-dir the FASTQ run takes the batched engine,
# whose covariate histogram and pass-4 gather run on the card too
ROUTES = ("fastq", "fastq_stream", "bam_stream")
BATCHED = "fastq_batched"


def run_cli_route(route: str, fq: str, bam: str, workdir: str, tag: str,
                  batch: int = BATCH, k: int = K):
    """One `kbbq-tpu recalibrate` through the CLI's own main():
    (output qualities, wall seconds, per-pass timings)."""
    from kbbq_tpu.cli.main import main as cli_main

    common = ["-k", str(k), "-c", str(COVERAGE), "--batch-size", str(batch)]
    if route == "bam_stream":
        out = os.path.join(workdir, f"{tag}.out.bam")
        argv = ["recalibrate", bam, "-o", out, *common, "--stream",
                "--set-oq"]
    else:
        out = os.path.join(workdir, f"{tag}.{route}.out.fq")
        argv = ["recalibrate", fq, "-o", out, *common, "--interleaved"]
        if route == "fastq_stream":
            argv.append("--stream")
        elif route == BATCHED:
            argv += ["--checkpoint-dir",
                     os.path.join(workdir, f"{tag}.ckpt")]
    sink: dict = {}
    with engine_timings(sink):
        t0 = time.time()
        rc = cli_main(argv)
        wall = time.time() - t0
    check(rc == 0, f"CLI {route} exit code {rc}")
    quals = (bam_quals(out, k) if route == "bam_stream"
             else fastq_quals(out, READ_LEN))
    return quals, wall, sink


def _peak_bytes() -> int | None:
    import jax
    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def phase_full_width(workdir: str, card: str, golden=None,
                     bench_reads: int = BENCH_READS,
                     full_reads: int = ECOLI_READS,
                     batch: int = BATCH, k: int = K) -> dict:
    """The CLI on the bench dataset (against the CPU golden) and on the
    full-width E. coli run (three routes identical), cold then warm."""
    import numpy as np

    import bench

    res = {}
    t0 = time.time()
    _, fq, bam = make_run_files(workdir, bench_reads, "bench")
    log(f"bench dataset staged: {bench_reads} reads "
        f"({time.time() - t0:.1f}s set-up)")
    t0 = time.time()
    want = bench.finish_golden(*golden) if golden else None
    check(want is not None, "CPU golden missing")
    log(f"CPU golden ready (waited {time.time() - t0:.1f}s, set-up)")
    for route in ROUTES + (BATCHED,):
        q, wall, _ = run_cli_route(route, fq, bam, workdir, "bench",
                                   batch=batch, k=k)
        ok = bool(np.array_equal(q, want))
        res[f"bench_{route}_vs_cpu_golden"] = ok
        log(f"bench {route}: {bench_reads} reads in {wall:.2f}s "
            f"(cold, compile included), equals CPU golden: {ok}")
    check(all(res.values()), f"CPU golden mismatch: {res}")

    t0 = time.time()
    _, fq, bam = make_run_files(workdir, full_reads, "ecoli")
    log(f"E. coli dataset staged: {full_reads} reads, FASTQ "
        f"{os.path.getsize(fq) >> 20} MB, BAM {os.path.getsize(bam) >> 20}"
        f" MB ({time.time() - t0:.1f}s set-up)")
    outs = {}
    for route in ROUTES:
        for run in ("cold", "warm"):
            q, wall, timings = run_cli_route(route, fq, bam, workdir,
                                             "ecoli", batch=batch, k=k)
            log(f"E. coli {route} {run}: {full_reads} reads in "
                f"{wall:.3f}s = {full_reads / wall:.1f} reads/s "
                f"[{card}]; peak device bytes {_peak_bytes()}; "
                f"timings {json.dumps(timings)}")
            res[f"ecoli_{route}_{run}_s"] = round(wall, 3)
            outs.setdefault(route, q)
            check(np.array_equal(outs[route], q),
                  f"{route} cold and warm outputs differ")
    same = all(np.array_equal(outs[ROUTES[0]], outs[r]) for r in ROUTES)
    log(f"E. coli routes identical: {same}")
    check(same, "full-width routes disagree")
    return res


# --------------------------------------------------------- four cards

def _placement(arr) -> str:
    shards = sorted((s.device.id, tuple(s.data.shape))
                    for s in arr.addressable_shards)
    return f"{arr.sharding} shards={shards}"


@contextlib.contextmanager
def filter_placement(sink: list):
    """Record where each multi-card engine's Bloom filters live."""
    from kbbq_tpu.parallel import resident_sharded, sharded_bloom

    build = resident_sharded.build_resident_sharded
    run_pass2 = sharded_bloom.ShardedBloomRecalPipeline.run_pass2

    def build_wrapped(*a, **kw):
        fns = list(build(*a, **kw))
        merge = fns[2]

        def merge_rows(acc):
            out = merge(acc)
            n = sum(w.startswith("replicated") for w, _ in sink)
            sink.append((f"replicated {'AB'[n % 2]}", _placement(out)))
            return out

        fns[2] = merge_rows
        return tuple(fns)

    def pass2_wrapped(self, *a, **kw):
        out = run_pass2(self, *a, **kw)
        sink.append(("sharded A", _placement(self.packed_a)))
        sink.append(("sharded B", _placement(self.packed_b)))
        return out

    resident_sharded.build_resident_sharded = build_wrapped
    sharded_bloom.ShardedBloomRecalPipeline.run_pass2 = pass2_wrapped
    try:
        yield sink
    finally:
        resident_sharded.build_resident_sharded = build
        sharded_bloom.ShardedBloomRecalPipeline.run_pass2 = run_pass2


def phase_four_cards(card: str, devices: int = 4,
                     full_reads: int = ECOLI_READS, midscale=None) -> dict:
    """run_pipeline(devices=4) in both layouts against one card, on the
    midscale golden (`midscale`: midscale_dataset()'s tuple) and on the
    full-width dataset."""
    import jax
    import numpy as np

    from kbbq_tpu.pipeline import RecalConfig
    from kbbq_tpu.pipeline.recalibrate import run_pipeline
    from kbbq_tpu.utils.synth import make_arrays_fast

    check(len(jax.devices()) >= devices,
          f"need {devices} devices, have {len(jax.devices())}")
    arrays, cfg, want, _ = midscale or midscale_dataset()
    genome = max(1000, int(full_reads * READ_LEN / COVERAGE))
    full, _ = make_arrays_fast(genome_len=genome, read_len=READ_LEN,
                               num_reads=full_reads, error_rate=0.005,
                               seed=0)
    full_cfg = RecalConfig(k=K, coverage=COVERAGE, batch_size=BATCH)
    res = {}
    for name, arr, c, ref, runs in (
            ("midscale", arrays, cfg, want, ("cold",)),
            ("ecoli", full, full_cfg, None, ("cold", "warm"))):
        t0 = time.time()
        one = np.asarray(run_pipeline(arr, c), np.int8)
        log(f"{name} one card: {time.time() - t0:.2f}s")
        if ref is not None:
            check(np.array_equal(one, ref), f"{name} one card vs golden")
        for layout in ("replicated", "sharded"):
            for run in runs:
                placed: list = []
                with filter_placement(placed):
                    t0 = time.time()
                    got = np.asarray(run_pipeline(
                        arr, c, devices=devices, bloom_layout=layout),
                        np.int8)
                    wall = time.time() - t0
                same = bool(np.array_equal(got, one))
                res[f"{name}_{layout}_{run}"] = same
                log(f"{name} --devices {devices} {layout} {run}: "
                    f"{arr.num_reads} reads in {wall:.3f}s = "
                    f"{arr.num_reads / wall:.1f} reads/s [{card}]; "
                    f"equals one card: {same}")
                if run == "cold":
                    for which, where in placed:
                        log(f"  filter {which}: {where}")
    check(all(res.values()), f"four-card mismatch: {res}")
    return res


# --------------------------------------------------------------- main

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card path and its one-card "
                         "comparison")
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(ROOT, "kbbq_tpu")):
        print("chip_smoke: run it from the root of a kbbq-tpu checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)          # the package and bench.py
    info = phase_device()
    card = info["card"]
    if args.four_cards:
        phase_four_cards(card)
    else:
        import bench
        golden = bench.start_golden(BENCH_READS, READ_LEN, K, BATCH)
        try:
            phase_ops()
            with tempfile.TemporaryDirectory(dir=ROOT,
                                             prefix=".smoke_") as wd:
                phase_golden(wd)
                phase_full_width(wd, card, golden=golden)
        finally:
            proc = golden[0]
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()
    import jax
    dev = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": dev[0].platform, "kind": dev[0].device_kind,
        "count": len(dev)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
