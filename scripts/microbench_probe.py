"""Bulk Bloom probe microbench: what each random-word fetch form costs.

The two bulk query streams (pass-2 trusted query + pass-3 initial
all-window query, ~49M probes each at the 400k bench) are gathers of
one uint32 block word per k-mer.  This times the XLA candidates on the
device JAX finds (run it on the card; CPU numbers say nothing of it):

  xla_word        packed[block] one-u32 gather + bit test (baseline)
  xla_full_query  ops/bloom.py::bloom_query_rows production twin
  xla_rowK        (M/K, K) row gather — per-INDEX cost vs payload width

Timing: one call at >=1M probes, best of 3, synced by a scalar d2h
read.  Prints the card's name and power limit beside the results.

    python scripts/microbench_probe.py
"""
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from kbbq_tpu.ops.bloom import bloom_query_rows  # noqa: E402
from kbbq_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402
from kbbq_tpu.utils.device import (device_info,  # noqa: E402
                                   gpu_name_and_power_limit)

enable_compile_cache()

_u32 = jnp.uint32


def sync(x):
    return float(jnp.sum(jax.tree_util.tree_leaves(x)[0].reshape(-1)[:1]
                         .astype(jnp.float32)))


def timeit(label, fn, *args, reps=3, n_probes=None):
    try:
        fn_j = jax.jit(fn)
        sync(fn_j(*args))  # compile
        best = 1e9
        for _ in range(reps):
            t0 = time.time()
            sync(fn_j(*args))
            best = min(best, time.time() - t0)
    except Exception as e:
        msg = str(e).replace("\n", " | ")[:200]
        print(f"{label} FAILED: {msg}", flush=True)
        return {"label": label, "error": msg}
    per = best / n_probes * 1e9
    print(f"{label}: {best*1e3:.1f} ms  ({per:.2f} ns/probe)", flush=True)
    return {"label": label, "ms": round(best * 1e3, 1),
            "ns_per_probe": round(per, 2)}


# ----------------------------------------------------------- datasets
LOG2_M = 26                       # 2^26 bits = 2^21 words = 8 MB packed
M = 1 << (LOG2_M - 5)
R = M // 128
N = 48_000_000
rng = np.random.default_rng(0)
packed = jnp.asarray(rng.integers(0, 2**32, M, dtype=np.uint32))
block = jnp.asarray(rng.integers(0, M, N, dtype=np.int32))
h2 = jnp.asarray(rng.integers(0, 2**32, N, dtype=np.uint32))
hi = jnp.asarray(rng.integers(0, 2**32, N, dtype=np.uint32))
lo = jnp.asarray(rng.integers(0, 2**32, N, dtype=np.uint32))
print(f"staged: filter {M*4>>20} MB, {N/1e6:.0f}M probes", flush=True)

results = []


# ------------------------------------------------------ XLA baselines
def xla_word(p, b, h):
    w = p[b]
    off = (h & _u32(31)).astype(_u32)
    return ((w >> off) & _u32(1)) > 0


results.append(timeit("xla_word", xla_word, packed, block, h2,
                      n_probes=N))
results.append(timeit("xla_full_query",
                      lambda p, a, b: bloom_query_rows(p, a, b, 4),
                      packed, hi, lo, n_probes=N))

# row gathers materialize [N, K] — cap N so it fits device memory
N_ROW = 2_000_000
for K in (8, 32):
    p2 = packed.reshape(M // K, K)
    r = block[:N_ROW] >> int(np.log2(K))
    results.append(timeit(f"xla_row{K}",
                          lambda p, rr: p[rr][:, 0], p2, r,
                          n_probes=N_ROW))

print(gpu_name_and_power_limit(), flush=True)
print(json.dumps({"device": device_info(), "M_words": M,
                  "results": results}), flush=True)
