"""chr20-scale oracle spot-check (round-4 VERDICT next #2, second half).

The chr20 parity gate compares the card's run to a CPU-backend twin of
the SAME engine; this script breaks that circle AT SCALE: it runs passes
1-2 on the card at the full chr20 sizing (filter B = 2^31 slots), pulls
the final packed trusted filter to the host, and re-derives pass-3
error calls for a 10k-read sample two ways —

  device: ops/inference.infer_errors on the device rows
  oracle: oracle/lighter.infer_read_errors per read on an OracleBloom
          wrapping the UNPACKED device filter bits

— asserting the decisions identical.  This checks the at-scale walk
(real 256 MB filter, real FPR pattern) against the NumPy spec without
a 76-minute full-oracle run.

Usage: python scripts/chr20_oracle_spot.py   (needs the staged chr20
FASTQ; CHR20_READS to shrink)
"""
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

DATA = os.environ.get("CHR20_DATA", os.path.join(ROOT, ".chr20_data"))
READS = int(os.environ.get("CHR20_READS", 13_000_000))
SAMPLE = int(os.environ.get("CHR20_SPOT_SAMPLE", 8192))  # production
# batch width (the walk is only ever dispatched at B=8192 in the
# engines)
LEN = 150
COVERAGE = 30.0
K = 32
IN_FQ = os.path.join(DATA, f"in_r{READS}.fq")


def _log(msg):
    print(f"[spot {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
          flush=True)


def main():
    import jax
    import jax.numpy as jnp

    from kbbq_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    from kbbq_tpu.pipeline import RecalConfig
    from kbbq_tpu.pipeline.stream_resident import (
        DEFAULT_CHUNK_READS,
        FastqWindowSource,
        StreamResidentEngine,
        scan_fastq_files,
    )

    _log(f"device: {jax.devices()[0]}")
    cfg = RecalConfig(k=K, coverage=COVERAGE, batch_size=8192)
    scan = scan_fastq_files([IN_FQ], K, DEFAULT_CHUNK_READS)
    src = FastqWindowSource([IN_FQ], scan, True, DEFAULT_CHUNK_READS)
    eng = StreamResidentEngine(src, cfg)
    t0 = time.time()
    eng.run_pass1()
    _log(f"pass1 {time.time() - t0:.1f}s")
    t0 = time.time()
    eng.run_pass2()
    _log(f"pass2 {time.time() - t0:.1f}s")

    # ---- the sample: first SAMPLE reads of the input
    from kbbq_tpu.io.fastq import extract_padded_arrays, \
        parse_fastq_bytes
    head = []
    with open(IN_FQ, "rb") as f:
        for _ in range(4 * SAMPLE):
            head.append(f.readline())
    fq = parse_fastq_bytes(b"".join(head))
    codes, quals, mask, lens = extract_padded_arrays(fq)
    assert codes.shape[0] == SAMPLE

    # ---- device decisions on the REAL device filter
    from kbbq_tpu.constants import DEFAULT_EXT_CAP
    from kbbq_tpu.ops.inference import infer_errors
    t0 = time.time()
    errs_dev = np.asarray(infer_errors(
        eng.rows_b, jnp.asarray(codes), K, cfg.num_hashes,
        walk_chunk=cfg.walk_chunk, ext_cap=cfg.ext_cap))
    _log(f"device walk on {SAMPLE} reads: {time.time() - t0:.1f}s")

    # ---- oracle decisions on the SAME filter bits
    rows_b = np.asarray(eng.rows_b)          # uint32 [m/32]
    params_b = eng.params_b
    _log(f"filter B: 2^{params_b.log2_m} slots, "
         f"{rows_b.nbytes >> 20} MB packed")
    from kbbq_tpu.oracle.bloom import OracleBloom
    ob = OracleBloom.__new__(OracleBloom)
    ob.params = params_b
    ob._set = None
    t0 = time.time()
    ob.slots = np.unpackbits(
        rows_b.view(np.uint8), bitorder="little").astype(np.uint8)
    assert ob.slots.size == params_b.m
    _log(f"unpacked to byte slots in {time.time() - t0:.1f}s")

    from kbbq_tpu.oracle.lighter import infer_read_errors
    ext_cap = min(cfg.ext_cap if cfg.ext_cap is not None
                  else DEFAULT_EXT_CAP, K)
    t0 = time.time()
    mism = 0
    for i in range(SAMPLE):
        want = infer_read_errors(codes[i][:int(lens[i])], K, ob,
                                 ext_cap=ext_cap)
        got = errs_dev[i][:int(lens[i])]
        if not np.array_equal(got, want):
            mism += 1
            if mism <= 5:
                _log(f"MISMATCH read {i}: dev "
                     f"{np.flatnonzero(got).tolist()} vs oracle "
                     f"{np.flatnonzero(want).tolist()}")
    _log(f"oracle walk on {SAMPLE} reads: {time.time() - t0:.1f}s")
    n_err_reads = int((errs_dev.any(axis=1)).sum())
    print({"sample": SAMPLE, "mismatched_reads": mism,
           "reads_with_errors": n_err_reads,
           "filter_b_log2_m": params_b.log2_m})
    assert mism == 0, f"{mism} reads diverge from the oracle"
    _log("oracle spot-check PASSED")


if __name__ == "__main__":
    main()
