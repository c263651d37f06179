"""Multi-host (multi-process) scaling: NVLink within a host, the host
network across hosts.

The reference has no distributed backend at all (SURVEY.md §2); this is
the new multi-host design:

  * every host runs the same program under `jax.distributed`
    (coordinator address from env or args — standard multi-controller
    JAX);
  * the graph and k-mer table are replicated per host (they are tiny:
    viral genomes);
  * each host loads a disjoint stripe of the read pairs (contiguous
    blocks by process index — no cross-host read shuffling needed since
    integer accumulation is order-invariant);
  * the global mesh spans all hosts' devices on the `data` axis (and
    optionally `model` within each host); the single psum at the end of
    the PE step merges per-device matrices over NVLink within a host and
    over the network across hosts — bit-identical to the serial loop.

Single-process runs degrade to parallel.mesh.infer_pe_links_sharded.
"""

from __future__ import annotations

import logging
import os
from typing import Optional, Sequence

import numpy as np

import jax

from vstrains_tpu.core.fastq import ReadPairBatch, load_read_pairs
from vstrains_tpu.ops.pe_infer import (PEResult, PESparseResult,
                                       _merge_coo)
from vstrains_tpu.parallel.mesh import (infer_pe_links_sharded,
                                        infer_pe_links_sparse_sharded,
                                        make_mesh)

_LOG = logging.getLogger(__name__)


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     logger: logging.Logger = None) -> int:
    """Initialize multi-controller JAX. No-ops for single-process runs.

    Arguments default to the standard env vars
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID).
    Returns the process index.
    """
    logger = logger or _LOG
    coordinator_address = (coordinator_address
                          or os.environ.get("JAX_COORDINATOR_ADDRESS"))
    if num_processes is None:
        env = os.environ.get("JAX_NUM_PROCESSES")
        num_processes = int(env) if env else None
    if process_id is None:
        env = os.environ.get("JAX_PROCESS_ID")
        process_id = int(env) if env else None
    if coordinator_address or (num_processes and num_processes > 1):
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id)
        logger.info("jax.distributed: process %d/%d, %d/%d local devices",
                    jax.process_index(), jax.process_count(),
                    jax.local_device_count(), jax.device_count())
    return jax.process_index()


def host_read_stripe(fwd_path: str, rve_path: str, split_len: int,
                     process_id: int, process_count: int) -> ReadPairBatch:
    """This host's contiguous stripe of the usable read pairs.

    Loading happens host-side then slicing by stripe; for truly huge
    FASTQs, pre-split the files per host and pass per-host paths instead.
    """
    batch = load_read_pairs(fwd_path, rve_path, split_len)
    n = batch.num_pairs
    per = -(-n // process_count)
    lo = min(process_id * per, n)
    hi = min(lo + per, n)
    return ReadPairBatch(
        batch.fwd_codes[lo:hi], batch.fwd_len[lo:hi],
        batch.rve_codes[lo:hi], batch.rve_len[lo:hi],
        batch.n_reads, batch.short_reads, hi - lo)


def infer_pe_links_multihost(ids: Sequence[str], seqs: Sequence[str],
                             local_reads: ReadPairBatch, kmer_size: int,
                             model: int = 1,
                             batch_size: int = 16384,
                             logger: logging.Logger = None) -> PEResult:
    """PE-link inference over all hosts' devices.

    `local_reads` is this host's stripe. Per-host partial matrices are
    computed with the DPxTP sharded step over the *local* devices, then
    all-reduced across processes (integer sums — order-free). This
    two-level merge (psum inside the step, allreduce across
    hosts) matches the north-star design and avoids constructing global
    arrays from per-host data.
    """
    logger = logger or _LOG
    n_local = jax.local_device_count()
    mesh = make_mesh(data=n_local // model, model=model,
                     devices=jax.local_devices())
    local = infer_pe_links_sharded(ids, seqs, local_reads, kmer_size,
                                   mesh, batch_size=batch_size,
                                   logger=logger)
    if jax.process_count() == 1:
        return local
    if isinstance(local, PESparseResult):
        # the sharded driver auto-routed to the sparse COO engine
        # (large N); merge COO chunks across hosts instead of matrices
        return _merge_sparse_hosts(ids, local)

    # cross-host merge: sum the int64 host matrices across processes.
    # jnp runs without x64, so each matrix travels as (low31, high) int32 halves
    # and is reassembled exactly on host.
    import jax.numpy as jnp
    from jax.experimental.multihost_utils import process_allgather

    def merge_int64(mat: np.ndarray) -> np.ndarray:
        low = jnp.asarray((mat & 0x7FFFFFFF).astype(np.int32))
        high = jnp.asarray((mat >> 31).astype(np.int32))
        g_low = np.asarray(process_allgather(low), dtype=np.int64)
        g_high = np.asarray(process_allgather(high), dtype=np.int64)
        return (g_low + (g_high << 31)).sum(axis=0)

    node_mat = merge_int64(local.node_mat)
    short_mat = merge_int64(local.short_mat)
    return PEResult(list(ids), node_mat, short_mat, local.n_reads,
                    local.short_reads, local.used_reads)


def _allgather_ragged_int64(arr: np.ndarray):
    """process_allgather of per-host int64 arrays of DIFFERENT lengths:
    gather sizes first, zero-pad to the max, travel as (low31, high)
    int32 halves (jnp runs without x64), reassemble exactly and strip
    each host's padding. Returns the per-host list."""
    import jax.numpy as jnp
    from jax.experimental.multihost_utils import process_allgather

    n = np.asarray([arr.shape[0]], np.int32)
    sizes = np.asarray(process_allgather(jnp.asarray(n))).reshape(-1)
    m = max(1, int(sizes.max()))
    pad = np.zeros(m, np.int64)
    pad[: arr.shape[0]] = arr
    low = jnp.asarray((pad & 0x7FFFFFFF).astype(np.int32))
    high = jnp.asarray((pad >> 31).astype(np.int32))
    g_low = np.asarray(process_allgather(low), dtype=np.int64)
    g_high = np.asarray(process_allgather(high), dtype=np.int64)
    full = g_low + (g_high << 31)
    return [full[i, : sizes[i]] for i in range(len(sizes))]


def _merge_sparse_hosts(ids: Sequence[str],
                        local: PESparseResult) -> PESparseResult:
    """Cross-host merge of per-host sparse COO results: allgather the ragged
    (keys, counts) chunks and re-reduce — integer sums over sorted
    unique keys, bit-identical to a single-host run on the union of
    stripes."""
    pk = _allgather_ragged_int64(local.pair_keys)
    pc = _allgather_ragged_int64(local.pair_counts)
    sk = _allgather_ragged_int64(local.short_keys)
    sc = _allgather_ragged_int64(local.short_counts)
    pair_keys, pair_counts = _merge_coo(pk, pc)
    short_keys, short_counts = _merge_coo(sk, sc)
    return PESparseResult(list(ids), pair_keys, pair_counts,
                          short_keys, short_counts, local.n_reads,
                          local.short_reads, local.used_reads)


def infer_pe_links_sparse_multihost(ids: Sequence[str],
                                    seqs: Sequence[str],
                                    local_reads: ReadPairBatch,
                                    kmer_size: int, model: int = 1,
                                    batch_size: int = 8192,
                                    logger: logging.Logger = None
                                    ) -> PESparseResult:
    """Explicit multi-host large-N path: the sharded sparse COO engine
    over this host's local devices (DP reads x TP table), per-host COO
    chunks merged across processes. Single-process runs degrade to
    infer_pe_links_sparse_sharded."""
    logger = logger or _LOG
    n_local = jax.local_device_count()
    mesh = make_mesh(data=n_local // model, model=model,
                     devices=jax.local_devices())
    local = infer_pe_links_sparse_sharded(
        ids, seqs, local_reads, kmer_size, mesh,
        batch_size=batch_size, logger=logger)
    if jax.process_count() == 1:
        return local
    return _merge_sparse_hosts(ids, local)
