"""Scaling-efficiency harness: the BASELINE measurement points
(1 card / 1 host / >=2 hosts, reads/s per card per point + efficiency).

`run_points` produces the measurement-point schema on whatever devices
`jax.devices()` offers (tests/test_scaling_harness.py drives it on the
virtual 8-device CPU mesh); `main` measures, so it needs GPUs and exits
2 on any other backend.

On GPUs:
  single host, all local cards:
      python bench_scaling.py
  multi-host (one process per host, same command everywhere):
      JAX_NUM_PROCESSES=<P> JAX_COORDINATOR=<host0:port> \
          python bench_scaling.py --multihost
Each point is parity-gated: every device count must produce bytes
identical to the 1-device run (shard invariance is a spec claim,
SURVEY.md H5).
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _log(msg):
    print(f"[scaling {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
          flush=True)


def run_points(num_reads: int, read_len: int, k: int, batch_size: int,
               devices_list, repeats: int = 2) -> dict:
    import jax
    import numpy as np

    from kbbq_tpu.parallel.mesh import make_mesh
    from kbbq_tpu.utils.device import device_info
    from kbbq_tpu.parallel.resident_sharded import (
        recalibrate_arrays_resident_sharded)
    from kbbq_tpu.pipeline import RecalConfig
    from kbbq_tpu.pipeline.resident import recalibrate_arrays_resident
    from kbbq_tpu.utils.synth import make_arrays_fast

    avail = len(jax.devices())
    devices_list = [d for d in devices_list if d <= avail]
    coverage = 50.0
    genome_len = max(1000, int(num_reads * read_len / coverage))
    arrays, _ = make_arrays_fast(genome_len=genome_len, read_len=read_len,
                                 num_reads=num_reads, error_rate=0.005,
                                 seed=0)
    cfg = RecalConfig(k=k, coverage=coverage, batch_size=batch_size)

    points = []
    golden = None
    for D in devices_list:
        def once():
            if D == 1:
                return np.asarray(recalibrate_arrays_resident(arrays, cfg))
            mesh = make_mesh(D)
            return np.asarray(recalibrate_arrays_resident_sharded(
                arrays, cfg, mesh=mesh))

        _log(f"D={D}: warm-up (compile)")
        out = once()
        dt = None
        for rep in range(repeats):
            t0 = time.time()
            out = once()
            rep_dt = time.time() - t0
            _log(f"D={D} run {rep}: {rep_dt:.2f}s")
            dt = rep_dt if dt is None else min(dt, rep_dt)
        if golden is None:
            golden = out
            parity = True
        else:
            parity = bool((out == golden).all())
        rps = num_reads / dt
        points.append({
            "devices": D,
            "hosts": 1,
            "wall_s": round(dt, 3),
            "reads_per_sec": round(rps, 1),
            "reads_per_sec_per_chip": round(rps / D, 1),
            "parity_vs_1dev": parity,
        })
        _log(f"D={D}: {rps:.0f} reads/s ({rps / D:.0f}/chip), "
             f"parity={parity}")

    base = points[0]["reads_per_sec_per_chip"] if points else 1.0
    for p in points:
        p["efficiency_vs_1chip"] = round(
            p["reads_per_sec_per_chip"] / base, 4)
    return {
        "metric": "scaling_points",
        "unit": "reads/s/chip per measurement point",
        "device": device_info(),
        "num_reads": num_reads,
        "read_len": read_len,
        "points": points,
    }


def run_multihost(num_reads: int, read_len: int, k: int,
                  batch_size: int) -> dict:
    """>= 2 hosts measurement point: every host runs this same command
    under jax.distributed (JAX_NUM_PROCESSES / JAX_COORDINATOR); only
    process 0 prints.  Streams a per-host slice of a shared synthetic
    FASTQ through the multi-host driver (parallel/multihost.py)."""
    import os
    import tempfile

    import jax
    import numpy as np

    from kbbq_tpu.parallel.multihost import (
        init_multihost,
        recalibrate_fastq_multihost,
    )
    from kbbq_tpu.pipeline import RecalConfig
    from kbbq_tpu.utils.synth import make_arrays_fast

    init_multihost()
    from kbbq_tpu.utils.device import require_gpu
    require_gpu("bench_scaling.py --multihost")
    P = jax.process_count()
    coverage = 50.0
    genome_len = max(1000, int(num_reads * read_len / coverage))
    arrays, _ = make_arrays_fast(genome_len=genome_len, read_len=read_len,
                                 num_reads=num_reads, error_rate=0.005,
                                 seed=0)
    # all hosts see the same input file list (shared FS assumption, as
    # in production WGS runs); the driver partitions files across hosts
    tmp = os.environ.get("KBBQ_SCALING_TMP", tempfile.gettempdir())
    in_fq = os.path.join(tmp, f"scaling_{num_reads}.fq")
    if jax.process_index() == 0 and not os.path.exists(in_fq):
        lut = np.frombuffer(b"ACGTN", np.uint8)
        seq = lut[arrays.codes]
        qb = (arrays.quals + 33).astype(np.uint8)
        with open(in_fq + ".tmp", "wb") as f:
            for i in range(num_reads):
                f.write(b"@r%d\n" % i + seq[i].tobytes() + b"\n+\n"
                        + qb[i].tobytes() + b"\n")
        os.replace(in_fq + ".tmp", in_fq)
    cfg = RecalConfig(k=k, coverage=coverage, batch_size=batch_size)
    out_fq = os.path.join(tmp, f"scaling_out_p{jax.process_index()}.fq")

    recalibrate_fastq_multihost([in_fq], [out_fq], cfg,
                                interleaved=True)  # warm-up
    t0 = time.time()
    recalibrate_fastq_multihost([in_fq], [out_fq], cfg, interleaved=True)
    dt = time.time() - t0
    chips = len(jax.devices())
    rps = num_reads / dt
    return {
        "metric": "scaling_multihost_point",
        "hosts": P,
        "devices": chips,
        "wall_s": round(dt, 3),
        "reads_per_sec": round(rps, 1),
        "reads_per_sec_per_chip": round(rps / chips, 1),
        "process_index": jax.process_index(),
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int, default=200_000)
    ap.add_argument("--len", type=int, default=150, dest="read_len")
    ap.add_argument("-k", type=int, default=32)
    ap.add_argument("--batch-size", type=int, default=8192)
    ap.add_argument("--devices-list", default=None,
                    help="comma list of device counts (default: 1 and "
                         "all local devices)")
    ap.add_argument("--multihost", action="store_true",
                    help="run the >=2-hosts point under jax.distributed "
                         "(launch one identical process per host)")
    ap.add_argument("--repeats", type=int, default=2)
    args = ap.parse_args()
    from kbbq_tpu.utils.compile_cache import enable_compile_cache
    from kbbq_tpu.utils.device import require_gpu
    enable_compile_cache()

    if args.multihost:
        result = run_multihost(args.reads, args.read_len, args.k,
                               args.batch_size)
        import jax
        if jax.process_index() == 0:
            print(json.dumps(result))
        return 0

    import jax
    require_gpu("bench_scaling.py")
    avail = len(jax.devices())
    if args.devices_list:
        dl = [int(x) for x in args.devices_list.split(",")]
    else:
        dl = [1] if avail == 1 else sorted({1, avail})
    result = run_points(args.reads, args.read_len, args.k,
                        args.batch_size, dl, repeats=args.repeats)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
