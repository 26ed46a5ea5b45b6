"""Config-5 dress rehearsal at real sizing (round-4 VERDICT next #9).

An N-process CPU pod run with BOTH Bloom filters forced to 2^33 slots
(1 GiB packed each — WGS-sized) under the multi-host hash-space-SHARDED
layout: per-host filter memory must stay O(m / num_hosts), and the pod
output must bit-match the single-process 8-virtual-device sharded run
of the identical sizing.  Records the per-host peak-RSS table for
docs/SCALING.md.

Usage:
  python scripts/config5_rehearsal.py            # parent: stages, runs
  python scripts/config5_rehearsal.py --worker   # (internal)

Env knobs: C5_PROCS (default 8), C5_READS (default 12000),
C5_LOG2M (default 33).
"""
import json
import os
import resource
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PROCS = int(os.environ.get("C5_PROCS", "8"))
READS = int(os.environ.get("C5_READS", "12000"))
LOG2M = int(os.environ.get("C5_LOG2M", "33"))
K = 16
COV = 20.0
BATCH = 64 * PROCS
DATA = "/tmp/config5_rehearsal"
COORD = "127.0.0.1:29611"


def _stage():
    import numpy as np

    from kbbq_tpu.utils.synth import make_dataset, to_fastq_bytes
    os.makedirs(DATA, exist_ok=True)
    paths = []
    for i, seed in enumerate((71, 72, 73)):
        ds = make_dataset(genome_len=max(400, READS * 50 // 20 // 3),
                          read_len=50, coverage=COV / 3,
                          error_rate=0.02, seed=seed)
        p = os.path.join(DATA, f"in{i}.fq")
        with open(p, "wb") as f:
            f.write(to_fastq_bytes(ds))
        paths.append(p)
    return paths


def worker():
    import jax
    jax.config.update("jax_platforms", "cpu")
    from kbbq_tpu.parallel.multihost import init_multihost, \
        recalibrate_fastq_multihost
    from kbbq_tpu.pipeline import RecalConfig

    paths = [os.path.join(DATA, f"in{i}.fq") for i in range(3)]
    outs = [os.path.join(DATA, f"out{i}.fq") for i in range(3)]
    cfg = RecalConfig(k=K, coverage=COV, batch_size=BATCH,
                      min_log2_m=LOG2M)
    info = init_multihost()
    stats = recalibrate_fastq_multihost(paths, outs, cfg, info=info,
                                        bloom_layout="sharded")
    stats["peak_rss_mb"] = int(
        resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024)
    print(json.dumps(stats))


def main():
    import numpy as np
    paths = _stage()

    # ground truth: single-PROCESS 8-virtual-device sharded run at the
    # identical sizing
    env0 = dict(os.environ)
    env0["JAX_PLATFORMS"] = "cpu"
    env0["XLA_FLAGS"] = (env0.get("XLA_FLAGS", "")
                         + " --xla_force_host_platform_device_count=8"
                         ).strip()
    golden_code = f"""
import sys; sys.path.insert(0, {ROOT!r})
import jax; jax.config.update("jax_platforms", "cpu")
from kbbq_tpu.pipeline import RecalConfig
from kbbq_tpu.pipeline.recalibrate import recalibrate_fastq
paths = {paths!r}
outs = [p.replace("in", "want") for p in paths]
cfg = RecalConfig(k={K}, coverage={COV}, batch_size={BATCH},
                  min_log2_m={LOG2M})
recalibrate_fastq(paths, outs, cfg, devices=8, bloom_layout="sharded")
print("golden done")
"""
    t0 = time.time()
    r = subprocess.run([sys.executable, "-c", golden_code], env=env0,
                       capture_output=True, timeout=3600)
    assert r.returncode == 0, r.stderr.decode()[-3000:]
    print(f"[c5] golden single-process run: {time.time() - t0:.0f}s",
          flush=True)

    procs = []
    for pid in range(PROCS):
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "").replace(
            "--xla_force_host_platform_device_count=8", "")
            + f" --xla_force_host_platform_device_count="
              f"{8 // PROCS}").strip()
        env["JAX_COORDINATOR"] = COORD
        env["JAX_NUM_PROCESSES"] = str(PROCS)
        env["JAX_PROCESS_ID"] = str(pid)
        env["PYTHONPATH"] = ROOT + os.pathsep + \
            env.get("PYTHONPATH", "")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env))
    t0 = time.time()
    results = [p.communicate(timeout=3600) for p in procs]
    for p, (so, se) in zip(procs, results):
        assert p.returncode == 0, se.decode()[-4000:]
    stats = [json.loads(so.splitlines()[-1]) for so, _ in results]
    print(f"[c5] {PROCS}-process pod run: {time.time() - t0:.0f}s",
          flush=True)

    for i in range(3):
        got = open(os.path.join(DATA, f"out{i}.fq"), "rb").read()
        want = open(os.path.join(DATA, f"want{i}.fq"), "rb").read()
        assert got == want, f"file {i} differs from single-process run"
    print("[c5] output bit-matches the single-process sharded run")

    packed_mb_global = 2 * (1 << LOG2M) // 8 // 2**20
    per_host_share = packed_mb_global // PROCS
    print(f"[c5] global packed filters: {packed_mb_global} MB "
          f"(2 x 2^{LOG2M} slots); fair per-host share: "
          f"{per_host_share} MB")
    table = []
    for s in stats:
        table.append((s["process_id"], s["peak_rss_mb"]))
        print(f"[c5] host {s['process_id']}: peak RSS "
              f"{s['peak_rss_mb']} MB")
    worst = max(r for _, r in table)
    # O(shard) check: the per-host fair filter share plus a Python/JAX
    # runtime allowance (~580 MB measured) — a replicated layout would
    # put the FULL packed_mb_global in every host (2026-08-20 run:
    # 816-863 MB/host at 2 GiB global = 256 MB share)
    assert worst < per_host_share + 768, \
        f"per-host RSS {worst} MB is not O(shard)"
    print(json.dumps({"procs": PROCS, "log2_m": LOG2M,
                      "global_packed_mb": packed_mb_global,
                      "per_host_peak_rss_mb": [r for _, r in
                                               sorted(table)]}))


if __name__ == "__main__":
    if "--worker" in sys.argv:
        worker()
    else:
        main()
