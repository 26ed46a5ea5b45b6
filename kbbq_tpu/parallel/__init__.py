"""Multi-chip / multi-host parallelism (SURVEY.md §8.1 L4, §3.3).

What the reference doesn't have (it is a single-threaded CPU tool): data
parallelism over reads via a 1-D device mesh + shard_map, per-device
Bloom replicas merged with an all-reduce max at pass boundaries,
covariate tables merged by an all-reduce sum — all XLA collectives
(NCCL between GPUs), no hand-written communication.
"""

from .mesh import make_mesh
from .sharded import ShardedRecalPipeline, sharded_recalibrate_arrays
