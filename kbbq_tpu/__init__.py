"""kbbq-tpu: reference-free base quality score recalibration in JAX.

A from-scratch, accelerator-first re-design of the capabilities of
``adamjorr/kbbq`` (reference-free GATK-style BQSR driven by Lighter-style
k-mer error detection).

Architecture (see SURVEY.md §8):

- ``kbbq_tpu.oracle``   — pure-NumPy executable spec (the parity authority).
- ``kbbq_tpu.io``       — host-side codecs: FASTQ/BAM readers+writers, batcher.
- ``kbbq_tpu.ops``      — pure JAX kernels (encode, k-mers, Bloom, inference,
                          covariate accumulation) — the device compute path.
- ``kbbq_tpu.state``    — device-resident state containers (Bloom filters,
                          covariate tables) + checkpointing.
- ``kbbq_tpu.pipeline`` — the four recalibration passes as jitted programs.
- ``kbbq_tpu.parallel`` — mesh construction, sharding, collective merges.
- ``kbbq_tpu.cli``      — ``kbbq-tpu {recalibrate,benchmark,plot}``.

Reference provenance: /root/reference was empty at build time (SURVEY.md §0);
semantics follow SURVEY.md Appendix A with every open choice recorded in
``kbbq_tpu/oracle/DECISIONS.md``.
"""

__version__ = "0.1.0"
