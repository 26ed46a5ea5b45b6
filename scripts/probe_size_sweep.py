"""ns/probe of the XLA word gather vs FILTER SIZE: bench-scale filters
are ~8 MB, chr20/WGS filters 256 MB - 8 GB, where device-memory row
locality (and the card's L2) stop helping.  One long-lived process,
one >=48M-probe call per size; run it on the card.

    python scripts/probe_size_sweep.py
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
from kbbq_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

N = 48_000_000
results = {}
for log2_m in (26, 28, 31, 33):
    M = 1 << (log2_m - 5)                 # u32 words
    packed = jnp.ones((M,), jnp.uint32)
    rng = np.random.default_rng(log2_m)
    blocks = jnp.asarray(rng.integers(0, M, N, dtype=np.int64)
                         .astype(np.int32))

    @jax.jit
    def q(p, b):
        return jnp.sum(p[b], dtype=jnp.uint32)

    np.asarray(q(packed, blocks))          # compile + warm
    best = 9e9
    for _ in range(3):
        t0 = time.time()
        np.asarray(q(packed, blocks))
        best = min(best, time.time() - t0)
    ns = best / N * 1e9
    results[f"2^{log2_m} bits ({M * 4 >> 20} MB)"] = round(ns, 2)
    print(f"log2_m={log2_m} ({M * 4 >> 20:5d} MB packed): "
          f"{ns:.2f} ns/probe", flush=True)
    del packed, blocks
from kbbq_tpu.utils.device import device_info  # noqa: E402

print(json.dumps({"device": device_info(), "results": results}))
