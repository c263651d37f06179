"""vstrains_tpu — a device-accelerated viral-quasispecies strain
reconstruction engine.

Re-designed from scratch for accelerators (JAX/XLA, sharded with
shard_map) with the capabilities of VStrains (reference:
/root/reference): given a SPAdes assembly graph (GFA 1.0), SPAdes
contigs.paths, and paired-end FASTQ reads, reconstruct full-length viral
haplotypes.

Architecture (see docs/ARCHITECTURE.md):
  - reads are the tensor workload: paired-end link inference runs as a batched
    hash-probe + matmul-accumulation kernel over read shards, data-parallel
    across a device mesh with integer psum merges (bit-identical to serial).
  - the assembly graph is small host-ordered state with dense device views
    (GraphTensors) for the batched numeric passes (edge flow, histograms,
    frontier iterations).
  - the disentanglement / extension fixed-point loops are host orchestration
    dispatching device passes (control-flow heavy, data-dependent shapes).
"""

__version__ = "0.1.0"

from vstrains_tpu.core.graph import AssemblyGraph  # noqa: F401

# Activate the persistent XLA compilation cache at import: env-var-only
# activation silently fails when jax is imported before user code (see
# utils/jaxcache.py), and a missed activation makes every process
# recompile every kernel. Idempotent, honors an explicit
# JAX_COMPILATION_CACHE_DIR value, and never raises.
from vstrains_tpu.utils.jaxcache import enable_persistent_cache as _epc

_epc()
del _epc
