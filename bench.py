"""Headline benchmark: reads/s per card for the full k-mer-count +
recalibrate pipeline on an E.-coli-scale synthetic dataset (BASELINE.md
config 2).

Prints ONE JSON line: {"metric", "value", "unit", "parity", "device",
"detail"}; `device` is JAX's {platform, kind, count}.  Needs a GPU: on
any other backend it exits 2 without measuring.  Use --quick for a
smaller dataset, --reads/--len to override.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from kbbq_tpu.utils.device import device_info, require_gpu


def _log(msg):
    print(f"[bench {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
          flush=True)


def _host_env() -> dict:
    """Fault-storm / hugepage sanity counters (docs/KNOWN_ISSUES.md #2),
    recorded into the bench JSON so a degraded host session is VISIBLE
    in the record instead of silently eaten by best-of-3 (round-3
    VERDICT weak #7).  A healthy session fills fresh anon memory at
    GB/s; the episodic fault-storm drops the plain-page rate ~40x while
    the MADV_HUGEPAGE rate stays high."""
    import numpy as np

    env = {}
    try:
        with open("/proc/vmstat") as f:
            vm = dict(line.split() for line in f if " " in line)
        env["thp_fault_alloc"] = int(vm.get("thp_fault_alloc", -1))
        env["pgmajfault"] = int(vm.get("pgmajfault", -1))
    except Exception:
        pass
    try:
        env["loadavg_1m"] = float(open("/proc/loadavg").read().split()[0])
    except Exception:
        pass
    try:
        from kbbq_tpu.utils.mem import hugepage_empty
        sz = 64 << 20
        w = np.empty(sz, np.uint8)
        w[:] = 1                       # warm-up: first fill of a fresh
        del w                          # process is cold for any layout
        t_plain = t_huge = None
        for _ in range(2):             # best-of-2: de-noise scheduling
            a = np.empty(sz, np.uint8)
            t0 = time.time()
            a[:] = 1
            t_plain = min(t_plain or 9e9, time.time() - t0)
            b = hugepage_empty(sz, np.uint8)
            t0 = time.time()
            b[:] = 1
            t_huge = min(t_huge or 9e9, time.time() - t0)
        env["fill_mbps_plain"] = round(64 / max(t_plain, 1e-9), 1)
        env["fill_mbps_huge"] = round(64 / max(t_huge, 1e-9), 1)
        # the #12 storm signature: plain-page fills collapse ~40x while
        # hugepage fills stay fast
        env["fault_storm"] = bool(env["fill_mbps_plain"] < 1000.0
                                  <= env["fill_mbps_huge"])
    except Exception:
        pass
    return env


def _golden_path(num_reads: int, read_len: int, k: int, batch_size: int,
                 ext_cap: int | None) -> str:
    import os

    from kbbq_tpu.constants import DEFAULT_EXT_CAP
    w = ext_cap if ext_cap is not None else DEFAULT_EXT_CAP
    key = f"r{num_reads}_l{read_len}_k{k}_b{batch_size}_v1_w{w}"
    cache_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             ".bench_cache")
    return os.path.join(cache_dir, f"golden_{key}.npy")


def start_golden(num_reads: int, read_len: int, k: int, batch_size: int,
                 ext_cap: int | None = None):
    """Start the CPU-backend golden for the bench dataset in a child
    process: (Popen or None when cached, .npy path).

    The CPU pipeline is oracle-verified by the test suite, so byte-
    equality against it IS oracle parity — a device run is never timed
    without checking its output.  The child has JAX_PLATFORMS=cpu in its
    environment (and switches in code too), so it never opens the card
    this process holds.  Cached on disk keyed by parameters."""
    import os
    import subprocess

    path = _golden_path(num_reads, read_len, k, batch_size, ext_cap)
    if os.path.exists(path):
        return None, path
    os.makedirs(os.path.dirname(path), exist_ok=True)
    code = (
        "import time; t0 = time.time()\n"
        "import jax, numpy as np\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        "from kbbq_tpu.pipeline import RecalConfig\n"
        "from kbbq_tpu.pipeline.recalibrate import recalibrate_arrays\n"
        "from kbbq_tpu.utils.synth import make_arrays_fast\n"
        f"g = max(1000, int({num_reads} * {read_len} / 50.0))\n"
        f"arrays, _ = make_arrays_fast(genome_len=g, read_len={read_len},"
        f" num_reads={num_reads}, error_rate=0.005, seed=0)\n"
        f"cfg = RecalConfig(k={k}, coverage=50.0, batch_size={batch_size},"
        f" ext_cap={ext_cap})\n"
        "out = recalibrate_arrays(arrays, cfg)\n"
        f"np.save({path + '.tmp.npy'!r}, out)\n"
        f"import os; os.replace({path + '.tmp.npy'!r}, {path!r})\n"
        "print(f'{time.time() - t0:.1f}')\n"
    )
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    _log(f"computing CPU golden for parity gate ({path}) ...")
    proc = subprocess.Popen(
        [sys.executable, "-c", code], env=env,
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    return proc, path


def finish_golden(proc, path: str, timeout: float = 7200):
    """Wait for start_golden's child; the golden array, or None."""
    import os

    import numpy as np
    if proc is not None:
        out, err = proc.communicate(timeout=timeout)
        if proc.returncode != 0 or not os.path.exists(path):
            _log(f"golden computation failed: {err.decode()[-500:]}")
            return None
        _log(f"CPU golden computed in {out.decode().strip()}s (child "
             f"process, CPU backend)")
    return np.load(path)


def golden_quals(num_reads: int, read_len: int, k: int,
                 batch_size: int,
                 ext_cap: int | None = None) -> "np.ndarray | None":
    """CPU-backend output for the bench dataset (the parity authority)."""
    return finish_golden(*start_golden(num_reads, read_len, k, batch_size,
                                       ext_cap))


def run(num_reads: int, read_len: int, k: int, batch_size: int,
        parity: bool = True, profile_dir: str | None = None,
        resident: bool = True, walk_chunk: int | None = None,
        ext_cap: int | None = None) -> dict:
    import contextlib

    import jax
    import numpy as np

    from kbbq_tpu.pipeline import RecalConfig
    from kbbq_tpu.pipeline.recalibrate import recalibrate_arrays
    from kbbq_tpu.utils.synth import make_arrays_fast

    dev = device_info()
    _log(f"device: {dev}")
    coverage = 50.0
    genome_len = max(1000, int(num_reads * read_len / coverage))
    arrays, _ = make_arrays_fast(
        genome_len=genome_len, read_len=read_len, num_reads=num_reads,
        error_rate=0.005, seed=0)
    cfg = RecalConfig(k=k, coverage=coverage, batch_size=batch_size,
                      walk_chunk=walk_chunk, ext_cap=ext_cap)
    _log(f"data ready: {num_reads} reads x {read_len}bp")

    prof = (jax.profiler.trace(profile_dir) if profile_dir
            else contextlib.nullcontext())
    pass_times = {}
    if resident:
        # device-resident variant: whole dataset on device once, one jit
        # dispatch per pass (pipeline/resident.py)
        from kbbq_tpu.pipeline.resident import recalibrate_arrays_resident
        recalibrate_arrays_resident(arrays, cfg)
        _log("warm-up (compile) done")
        # best of three timed runs (one when profiling: a traced run is
        # enough); each run is only ~seconds
        dt = None
        for rep in range(1 if profile_dir else 3):
            pt = {}
            t0 = time.time()
            with prof:
                out = recalibrate_arrays_resident(arrays, cfg,
                                                  timings=pt)
            rep_dt = time.time() - t0
            _log(f"timed run {rep}: {rep_dt:.2f}s ({pt})")
            if dt is None or rep_dt < dt:
                dt, pass_times = rep_dt, pt
        pass_times = dict(pass_times)
    else:
        # warm-up: full run on the SAME arrays so every jit signature
        # (incl. the data-dependent Bloom sizes) is compiled before timing
        recalibrate_arrays(arrays, cfg)
        _log("warm-up (compile) done")

        from kbbq_tpu.io.batcher import Batcher
        from kbbq_tpu.pipeline.recalibrate import RecalPipeline

        lens = arrays.mask.sum(axis=1)
        pipe = RecalPipeline(cfg, 1, arrays.max_len, int(lens.sum()),
                             int(np.maximum(lens - k + 1, 0).sum()))
        mk = lambda: Batcher(arrays, cfg.batch_size)
        t0 = time.time()
        with prof:
            for name, fn in [("pass1", lambda: pipe.run_pass1(mk())),
                             ("pass2", lambda: pipe.run_pass2(mk())),
                             ("pass3", lambda: pipe.run_pass3(mk())),
                             ("deltas", pipe.compute_recal_table)]:
                tp = time.time()
                fn()
                pass_times[name] = round(time.time() - tp, 3)
                _log(f"{name} done in {pass_times[name]}s")
            tp = time.time()
            out = pipe.run_pass4(mk())
            pass_times["pass4"] = round(time.time() - tp, 3)
            _log(f"pass4 done in {pass_times['pass4']}s")
        dt = time.time() - t0
    _log(f"timed run done in {dt:.2f}s ({pass_times})")

    parity_ok = None
    if parity:
        want = golden_quals(num_reads, read_len, k, batch_size, ext_cap)
        if want is not None:
            parity_ok = bool((out == want).all())
            _log(f"parity vs CPU golden: {parity_ok}")
            if not parity_ok:
                diff = int((out != want).sum())
                _log(f"PARITY FAILURE: {diff} differing quality values "
                     f"of {out.size}")

    rps = num_reads / dt
    return {
        "parity": parity_ok,
        "metric": "reads_per_sec_per_chip",
        "value": round(rps, 1),
        "unit": "reads/s/chip (full 4-pass recalibrate)",
        "device": dev,
        "detail": {
            "num_reads": num_reads,
            "read_len": read_len,
            "k": k,
            "batch_size": batch_size,
            "wall_s": round(dt, 3),
            "bases_per_sec": round(num_reads * read_len / dt, 1),
            "pass_times_s": pass_times,
        },
    }


def run_stream(num_reads: int, read_len: int, k: int, batch_size: int,
               parity: bool = True, chunk_reads: int = 131072,
               ext_cap: int | None = None) -> dict:
    """Streamed FASTQ->FASTQ datapoint (resident-window engine,
    pipeline/stream_resident.py): the path BASELINE configs 4-5 take.
    Writes the synthetic dataset to a temp FASTQ, times the full
    disk->disk run (scan + 4 re-streamed passes + write), and gates on
    the same CPU golden as the resident bench (the in-RAM and streamed
    pipelines are bit-identical by design; tests assert it)."""
    import os
    import tempfile

    import numpy as np

    from kbbq_tpu.pipeline import RecalConfig
    from kbbq_tpu.pipeline.streaming import recalibrate_fastq_streaming
    from kbbq_tpu.utils.synth import make_arrays_fast

    dev = device_info()
    _log(f"device: {dev}")
    coverage = 50.0
    genome_len = max(1000, int(num_reads * read_len / coverage))
    arrays, _ = make_arrays_fast(
        genome_len=genome_len, read_len=read_len, num_reads=num_reads,
        error_rate=0.005, seed=0)
    cfg = RecalConfig(k=k, coverage=coverage, batch_size=batch_size,
                      ext_cap=ext_cap)

    tmp = tempfile.mkdtemp(prefix="kbbq_bench_stream_")
    in_fq = os.path.join(tmp, "in.fq")
    out_fq = os.path.join(tmp, "out.fq")
    _write_synth_fastq(arrays, in_fq)     # outside the timed region
    _log(f"FASTQ staged: {os.path.getsize(in_fq) >> 20} MB")

    kwargs = dict(interleaved=True, chunk_reads=chunk_reads)
    recalibrate_fastq_streaming([in_fq], out_fq, cfg, **kwargs)
    _log("warm-up (compile) done")
    dt = None
    pass_times = {}
    for rep in range(3):
        t0 = time.time()
        recalibrate_fastq_streaming([in_fq], out_fq, cfg, **kwargs)
        rep_dt = time.time() - t0
        _log(f"timed run {rep}: {rep_dt:.2f}s")
        if dt is None or rep_dt < dt:
            dt = rep_dt

    parity_ok = None
    if parity:
        want = golden_quals(num_reads, read_len, k, batch_size, ext_cap)
        if want is not None:
            from kbbq_tpu.io.fastq import read_fastq
            fq = read_fastq(out_fq)
            got = np.zeros_like(want)
            for i in range(fq.num_reads):
                got[i] = np.frombuffer(fq.qual_bytes(i), np.uint8
                                       ).astype(np.int8) - 33
            parity_ok = bool((got == want).all())
            _log(f"parity vs CPU golden: {parity_ok}")

    rps = num_reads / dt
    return {
        "parity": parity_ok,
        "metric": "reads_per_sec_per_chip_streamed",
        "value": round(rps, 1),
        "unit": "reads/s/chip (streamed disk->disk 4-pass recalibrate)",
        "device": dev,
        "detail": {
            "num_reads": num_reads,
            "read_len": read_len, "k": k, "batch_size": batch_size,
            "chunk_reads": chunk_reads, "wall_s": round(dt, 3),
        },
    }


def _write_synth_fastq(arrays, path: str) -> None:
    """FASTQ render of the bench dataset: names r<ordinal>, interleaved
    pairs (odd ordinals are second-in-pair, as arrays.seconds)."""
    import numpy as np

    lut = np.frombuffer(b"ACGTN", np.uint8)
    num_reads = arrays.num_reads
    with open(path, "wb") as f:
        step = 65536
        for s in range(0, num_reads, step):
            e = min(num_reads, s + step)
            seq = lut[arrays.codes[s:e]]
            qb = (arrays.quals[s:e] + 33).astype(np.uint8)
            lines = []
            for i in range(e - s):
                lines.append(b"@r%d" % (s + i))
                lines.append(seq[i].tobytes())
                lines.append(b"+")
                lines.append(qb[i].tobytes())
            f.write(b"\n".join(lines) + b"\n")


def _write_synth_bam(arrays, path: str, level: int = 1) -> None:
    """Vectorized fixed-size-record BAM writer for the bench dataset:
    half the records are stored reverse-strand (so machine-order decode
    is exercised), read2 flags follow arrays.seconds, one RG."""
    import struct

    import numpy as np

    from kbbq_tpu.io import bgzf
    from kbbq_tpu.io.bam import CODE_TO_NIBBLE

    codes, quals = arrays.codes, arrays.quals
    N, L = codes.shape
    assert L % 2 == 0
    name_len = 9  # "r0000000\0"
    aux = b"RGZrg0\x00"
    nb = L // 2
    body = 32 + name_len + nb + L + len(aux)
    rec = 4 + body
    blob = np.zeros((N, rec), np.uint8)

    def put_i32(col: int, val):
        v = np.asarray(val, "<i4")
        blob[:, col:col + 4] = np.broadcast_to(
            v.reshape(-1, 1).view(np.uint8), (N, 4))

    put_i32(0, body)            # block_size
    put_i32(4, -1)              # refid
    put_i32(8, -1)              # pos
    blob[:, 12] = name_len
    rev = (np.arange(N) % 4) >= 2   # half reverse-strand
    flag = ((0x1 | 0x4 | 0x8)
            | np.where(arrays.seconds, 0x80, 0x40)
            | np.where(rev, 0x10, 0)).astype("<u2")
    blob[:, 18:20] = flag.reshape(-1, 1).view(np.uint8)
    put_i32(20, L)              # l_seq
    put_i32(24, -1)             # next_refid
    put_i32(28, -1)             # next_pos
    d = np.arange(N, dtype=np.int64)
    blob[:, 36] = ord("r")
    for p in range(7):
        blob[:, 37 + p] = 48 + (d // 10 ** (6 - p)) % 10
    # stored (alignment) orientation: RC + reverse for rev rows
    crev = np.where(codes < 4, 3 - codes, codes)[:, ::-1]
    store_c = np.where(rev[:, None], crev, codes)
    store_q = np.where(rev[:, None], quals[:, ::-1], quals)
    nibs = CODE_TO_NIBBLE[store_c]
    so = 36 + name_len
    blob[:, so:so + nb] = (nibs[:, 0::2] << 4) | nibs[:, 1::2]
    blob[:, so + nb:so + nb + L] = store_q.astype(np.uint8)
    blob[:, so + nb + L:] = np.frombuffer(aux, np.uint8)

    hdr = [b"BAM\x01"]
    text = b"@HD\tVN:1.6\n@RG\tID:rg0\n"
    hdr.append(struct.pack("<i", len(text)))
    hdr.append(text)
    hdr.append(struct.pack("<i", 0))  # no refs (all unmapped)
    raw = b"".join(hdr) + blob.tobytes()
    with open(path, "wb") as f:
        f.write(bgzf.compress(raw, level))


def run_bam(num_reads: int, read_len: int, k: int, batch_size: int,
            parity: bool = True, chunk_records: int = 65536,
            ext_cap: int | None = None) -> dict:
    """BAM->BAM datapoint (BASELINE config 3 shape): synthetic E.-coli-
    scale BAM through the resident-window streaming engine, --set-oq,
    with a decode-only sweep timed separately to attribute codec cost."""
    import os
    import tempfile

    import numpy as np

    from kbbq_tpu.pipeline import RecalConfig
    from kbbq_tpu.pipeline.stream_resident import (
        recalibrate_bam_stream_resident)
    from kbbq_tpu.utils.synth import make_arrays_fast

    dev = device_info()
    _log(f"device: {dev}")
    coverage = 50.0
    genome_len = max(1000, int(num_reads * read_len / coverage))
    arrays, _ = make_arrays_fast(
        genome_len=genome_len, read_len=read_len, num_reads=num_reads,
        error_rate=0.005, seed=0)
    cfg = RecalConfig(k=k, coverage=coverage, batch_size=batch_size,
                      ext_cap=ext_cap)
    tmp = tempfile.mkdtemp(prefix="kbbq_bench_bam_")
    in_bam = os.path.join(tmp, "in.bam")
    out_bam = os.path.join(tmp, "out.bam")
    _write_synth_bam(arrays, in_bam)
    _log(f"BAM staged: {os.path.getsize(in_bam) >> 20} MB")

    # decode-only sweep: what the codec layer costs per re-stream
    from kbbq_tpu.io.bam_stream import iter_bam_raw_chunks
    from kbbq_tpu.io.bam_vec import decode_machine_chunk
    from kbbq_tpu.pipeline.bam import scan_bam
    t0 = time.time()
    _, _, _, max_len, registry = scan_bam(in_bam, k)
    scan_s = time.time() - t0
    t0 = time.time()
    _, _, chunks = iter_bam_raw_chunks(in_bam, chunk_records)
    for buf, offs, sizes in chunks:
        decode_machine_chunk(buf, offs, sizes, max_len, registry)
    sweep_s = time.time() - t0
    _log(f"scan {scan_s:.2f}s, decode sweep {sweep_s:.2f}s")

    recalibrate_bam_stream_resident(in_bam, out_bam, cfg, set_oq=True,
                                    chunk_records=chunk_records)
    _log("warm-up (compile) done")
    dt, pass_times = None, {}
    for rep in range(3):
        pt = {}
        t0 = time.time()
        recalibrate_bam_stream_resident(in_bam, out_bam, cfg,
                                        set_oq=True,
                                        chunk_records=chunk_records,
                                        timings=pt)
        rep_dt = time.time() - t0
        _log(f"timed run {rep}: {rep_dt:.2f}s ({pt})")
        if dt is None or rep_dt < dt:
            dt, pass_times = rep_dt, pt

    parity_ok = None
    if parity:
        want = golden_quals(num_reads, read_len, k, batch_size, ext_cap)
        if want is not None:
            got = np.zeros_like(want)
            _, _, chunks = iter_bam_raw_chunks(out_bam, chunk_records)
            row = 0
            for buf, offs, sizes in chunks:
                c, q, m, r, s, lens, prim = decode_machine_chunk(
                    buf, offs, sizes, max_len, registry)
                got[row:row + prim.size] = q
                row += prim.size
            parity_ok = bool(row == want.shape[0] and (got == want).all())
            _log(f"parity vs CPU golden: {parity_ok}")

    rps = num_reads / dt
    # decode share: scan + one decode per re-streamed pass (3 filter/
    # covariate passes + pass 4) — an upper bound; prefetch overlaps it
    decode_share = (scan_s + 4 * sweep_s) / dt
    return {
        "parity": parity_ok,
        "metric": "reads_per_sec_per_chip_bam",
        "value": round(rps, 1),
        "unit": "reads/s/chip (BAM->BAM streamed 4-pass recalibrate)",
        "device": dev,
        "detail": {
            "num_reads": num_reads,
            "read_len": read_len, "k": k, "batch_size": batch_size,
            "chunk_records": chunk_records, "wall_s": round(dt, 3),
            "scan_s": round(scan_s, 3),
            "decode_sweep_s": round(sweep_s, 3),
            "decode_share_upper_bound": round(decode_share, 4),
            "pass_times_s": pass_times,
        },
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int, default=400_000)
    ap.add_argument("--len", type=int, default=150, dest="read_len")
    ap.add_argument("-k", type=int, default=32)
    ap.add_argument("--batch-size", type=int, default=8192)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--no-parity", action="store_true",
                    help="skip the CPU-golden output parity gate")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="capture a jax.profiler device trace of the "
                         "timed run into DIR")
    ap.add_argument("--walk-chunk", type=int, default=None,
                    help="pass-3 walk width (default ops.inference WALK_CHUNK)")
    ap.add_argument("--ext-cap", type=int, default=None,
                    help="walk trial-extension cap W (DECISIONS.md D7; "
                         "k = reference extend-to-k semantics)")
    ap.add_argument("--no-resident", action="store_true",
                    help="use the per-batch dispatch pipeline instead of "
                         "the device-resident one-dispatch-per-pass path")
    ap.add_argument("--stream", action="store_true",
                    help="streamed disk->disk FASTQ datapoint "
                         "(resident-window engine; bounded host memory)")
    ap.add_argument("--bam", action="store_true",
                    help="BAM->BAM datapoint (BASELINE config 3 shape: "
                         "streamed, --set-oq, half reverse-strand)")
    ap.add_argument("--chunk-reads", type=int, default=131072)
    ap.add_argument("--resident-only", action="store_true",
                    help="skip the streamed + BAM datapoints that the "
                         "default run appends to detail")
    args = ap.parse_args()
    if args.quick:
        args.reads = 50_000
    from kbbq_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    require_gpu("bench.py")
    if args.bam:
        result = run_bam(args.reads, args.read_len, args.k,
                         args.batch_size, parity=not args.no_parity,
                         ext_cap=args.ext_cap)
        print(json.dumps(result))
        return 0
    if args.stream:
        result = run_stream(args.reads, args.read_len, args.k,
                            args.batch_size,
                            parity=not args.no_parity,
                            chunk_reads=args.chunk_reads,
                            ext_cap=args.ext_cap)
        print(json.dumps(result))
        return 0
    host_env = _host_env()
    result = run(args.reads, args.read_len, args.k, args.batch_size,
                 parity=not args.no_parity,
                 profile_dir=args.profile,
                 resident=not args.no_resident,
                 walk_chunk=args.walk_chunk,
                 ext_cap=args.ext_cap)
    result["detail"]["host_env"] = host_env
    # the default record carries ALL THREE datapoints (round-3 VERDICT
    # weak #2: the streamed/BAM numbers were invisible to the driver).
    # Streamed + BAM run at the same read count so the cached CPU golden
    # is reused; each adds ~30-90 s of warm runs.
    if not (args.resident_only or args.profile or args.quick):
        for name, fn in (
                ("streamed", lambda: run_stream(
                    args.reads, args.read_len, args.k, args.batch_size,
                    parity=not args.no_parity,
                    chunk_reads=args.chunk_reads,
                    ext_cap=args.ext_cap)),
                ("bam", lambda: run_bam(
                    args.reads, args.read_len, args.k, args.batch_size,
                    parity=not args.no_parity, ext_cap=args.ext_cap))):
            try:
                sub = fn()
                result["detail"][name] = {
                    "value": sub["value"], "unit": sub["unit"],
                    "parity": sub["parity"], "detail": sub["detail"]}
            except Exception as e:  # a sub-bench must not eat the record
                result["detail"][name] = {"error": repr(e)}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
