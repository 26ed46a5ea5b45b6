"""chr20-class realistic-scale datapoint (BASELINE config 4; round-3
VERDICT #2): ~13M reads / 150 bp / 30x over a 65 Mb synthetic genome,
streamed FASTQ disk->disk through the resident-window engine.  Filter B
sizes to >= 2^31 slots (256 MB packed on device) — the first datapoint
where the Bloom filters leave the toy regime.

Usage:
  python scripts/chr20.py stage    # write the 4 GB input FASTQ (once)
  python scripts/chr20.py golden   # CPU-backend golden quals (~1-2 h)
  python scripts/chr20.py run      # the timed card run + parity gate

Stages persist under $CHR20_DATA (default <checkout>/.chr20_data) so
reruns skip them.
"""
import json
import os
import resource
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
DATA = os.environ.get("CHR20_DATA", os.path.join(ROOT, ".chr20_data"))
READS = int(os.environ.get("CHR20_READS", 13_000_000))
LEN = 150
COVERAGE = 30.0
K = 32
BATCH = 8192
GENOME = max(1000, int(READS * LEN / COVERAGE))
IN_FQ = os.path.join(DATA, f"in_r{READS}.fq")
GOLDEN = os.path.join(DATA, f"golden_r{READS}.npy")


def _log(msg):
    print(f"[chr20 {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
          flush=True)


def make_arrays():
    import numpy as np

    from kbbq_tpu.io.batcher import ReadArrays

    # chunked variant of utils/synth.make_arrays_fast (the one-shot
    # fancy-index builds a [N, L] int64 index = 15.6 GB at this scale)
    rng = np.random.default_rng(0)
    genome = rng.integers(0, 4, size=GENOME, dtype=np.int8)
    starts = rng.integers(0, GENOME - LEN + 1, size=READS)
    codes = np.empty((READS, LEN), np.int8)
    quals = np.empty((READS, LEN), np.int8)
    step = 1 << 20
    qpal = np.array([12, 20, 28, 37], dtype=np.int8)
    for s in range(0, READS, step):
        e = min(READS, s + step)
        idx = starts[s:e, None] + np.arange(LEN)
        c = genome[idx]
        quals[s:e] = qpal[rng.choice(4, size=(e - s, LEN),
                                     p=[0.1, 0.2, 0.3, 0.4])]
        err = rng.random((e - s, LEN)) < 0.005
        sub = (c + rng.integers(1, 4, size=c.shape)) % 4
        codes[s:e] = np.where(err, sub, c).astype(np.int8)
    mask = np.ones((READS, LEN), bool)
    rgs = np.zeros(READS, np.int32)
    seconds = (np.arange(READS) % 2 == 1)
    return ReadArrays(codes, quals, mask, rgs, seconds)


def stage():
    import numpy as np
    os.makedirs(DATA, exist_ok=True)
    if os.path.exists(IN_FQ):
        _log(f"already staged: {IN_FQ}")
        return
    _log(f"generating {READS} reads over a {GENOME} bp genome ...")
    arrays = make_arrays()
    _log("rendering FASTQ ...")
    lut = np.frombuffer(b"ACGTN", np.uint8)
    with open(IN_FQ + ".tmp", "wb") as f:
        step = 1 << 18
        for s in range(0, READS, step):
            e = min(READS, s + step)
            seq = lut[arrays.codes[s:e]]
            qb = (arrays.quals[s:e] + 33).astype(np.uint8)
            lines = []
            for i in range(e - s):
                lines.append(b"@r%d" % (s + i))
                lines.append(seq[i].tobytes())
                lines.append(b"+")
                lines.append(qb[i].tobytes())
            f.write(b"\n".join(lines) + b"\n")
    os.rename(IN_FQ + ".tmp", IN_FQ)
    _log(f"staged {os.path.getsize(IN_FQ) >> 20} MB")


def golden():
    """CPU-backend streamed run -> golden quals (bit-identical to the
    device path by design; the suite asserts engine equivalences)."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    if os.path.exists(GOLDEN):
        _log("golden already present")
        return
    from kbbq_tpu.pipeline import RecalConfig
    from kbbq_tpu.pipeline.stream_resident import \
        recalibrate_fastq_stream_resident
    cfg = RecalConfig(k=K, coverage=COVERAGE, batch_size=BATCH)
    out_fq = os.path.join(DATA, "golden_out.fq")
    t0 = time.time()
    recalibrate_fastq_stream_resident([IN_FQ], out_fq, cfg,
                                      interleaved=True)
    _log(f"golden run: {time.time() - t0:.0f}s")
    from kbbq_tpu.io.fastq import read_fastq
    fq = read_fastq(out_fq)
    got = np.zeros((READS, LEN), np.int8)
    for i in range(fq.num_reads):
        got[i] = np.frombuffer(fq.qual_bytes(i), np.uint8).astype(
            np.int8) - 33
    np.save(GOLDEN, got)
    os.unlink(out_fq)
    _log("golden saved")


def run():
    from kbbq_tpu.utils.compile_cache import enable_compile_cache
    from kbbq_tpu.utils.device import require_gpu
    enable_compile_cache()
    import numpy as np

    from kbbq_tpu.pipeline import RecalConfig
    from kbbq_tpu.pipeline.stream_resident import \
        recalibrate_fastq_stream_resident

    dev = require_gpu("chr20.py run")
    _log(f"device: {dev}")
    cfg = RecalConfig(k=K, coverage=COVERAGE, batch_size=BATCH)
    out_fq = os.path.join(DATA, "run_out.fq")
    timings = {}
    t0 = time.time()
    stats = recalibrate_fastq_stream_resident([IN_FQ], out_fq, cfg,
                                              interleaved=True,
                                              timings=timings)
    dt = time.time() - t0
    _log(f"cold run (includes compile): {dt:.1f}s  {timings}")
    # warm repeat = the honest throughput number (compile cached)
    timings2 = {}
    t0 = time.time()
    recalibrate_fastq_stream_resident([IN_FQ], out_fq, cfg,
                                      interleaved=True,
                                      timings=timings2)
    dt2 = time.time() - t0
    rss_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    parity = None
    if os.path.exists(GOLDEN):
        from kbbq_tpu.io.fastq import read_fastq
        want = np.load(GOLDEN)
        fq = read_fastq(out_fq)
        ok = fq.num_reads == READS
        if ok:
            step = 1 << 18
            for s in range(0, READS, step):
                e = min(READS, s + step)
                got = np.zeros((e - s, LEN), np.int8)
                for i in range(s, e):
                    got[i - s] = np.frombuffer(
                        fq.qual_bytes(i), np.uint8).astype(np.int8) - 33
                if not (got == want[s:e]).all():
                    ok = False
                    break
        parity = bool(ok)
        _log(f"parity vs CPU golden: {parity}")
    else:
        _log("no golden present — run `golden` first for the parity gate")
    print(json.dumps({
        "metric": "chr20_streamed_reads_per_sec_per_chip",
        "value": round(READS / dt2, 1),
        "parity": parity,
        "device": dev,
        "detail": {"num_reads": READS,
                   "read_len": LEN, "coverage": COVERAGE, "k": K,
                   "genome_len": GENOME,
                   "wall_cold_s": round(dt, 1),
                   "wall_warm_s": round(dt2, 1),
                   "pass_times_cold": timings,
                   "pass_times_warm": timings2,
                   "host_peak_rss_gb": round(rss_gb, 2),
                   "stats": stats}}))


if __name__ == "__main__":
    {"stage": stage, "golden": golden, "run": run}[sys.argv[1]]()
