"""Address-sorted probe batching: measure or disprove.

Large (chr20/WGS-class) filters pay a device-memory locality tax per
probe.  Candidate fix: sort each bulk query's probe block-ids, gather in
ascending-address order, and invert the permutation.  This prices every
leg on the card, one long-lived process:

  unsorted   — the production serialized gather (baseline repro)
  presorted  — gather with ALREADY ascending indices (locality ceiling)
  argsort    — the i32 sort alone
  full       — argsort + gather-sorted + unsort (the real candidate)

Verdict rule: `full` must beat `unsorted` at 256 MB+ for the rewrite to
pay; `presorted` bounds what perfect locality could ever give.
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
for log2_m in (28, 30, 31, 33):
    M = 1 << (log2_m - 5)                 # u32 words
    packed = jnp.ones((M,), jnp.uint32)
    rng = np.random.default_rng(log2_m)
    blocks_np = rng.integers(0, M, N, dtype=np.int64).astype(np.int32)
    blocks = jnp.asarray(blocks_np)
    blocks_sorted = jnp.asarray(np.sort(blocks_np))

    @jax.jit
    def q(p, b):
        return jnp.sum(p[b], dtype=jnp.uint32)

    @jax.jit
    def srt(b):
        return jnp.sum(jnp.argsort(b).astype(jnp.uint32))

    @jax.jit
    def full(p, b):
        order = jnp.argsort(b)
        hit = p[b[order]]
        # unsort: scatter-free inverse via a second gather
        inv = jnp.argsort(order)
        return jnp.sum(hit[inv], dtype=jnp.uint32)

    row = {}
    for name, fn, args in (
            ("unsorted", q, (packed, blocks)),
            ("presorted", q, (packed, blocks_sorted)),
            ("argsort", srt, (blocks,)),
            ("full", full, (packed, blocks))):
        np.asarray(fn(*args))              # compile + warm
        best = 9e9
        for _ in range(3):
            t0 = time.time()
            np.asarray(fn(*args))
            best = min(best, time.time() - t0)
        row[name] = round(best / N * 1e9, 2)
        print(f"log2_m={log2_m} ({M * 4 >> 20:5d} MB) {name:>9}: "
              f"{row[name]:.2f} ns/probe", flush=True)
    results[f"{M * 4 >> 20}MB"] = row
    del packed, blocks, blocks_sorted
from kbbq_tpu.utils.device import device_info  # noqa: E402

print(json.dumps({"device": device_info(), "results": results}))
