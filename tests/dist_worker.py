"""Child process for the two-process jax.distributed CPU test.

Usage: python dist_worker.py <coord> <nprocs> <pid> <data_dir> <out_npz>

Each process initializes multi-controller JAX on CPU, loads ITS stripe
of the read pairs (parallel/distributed.host_read_stripe), runs
infer_pe_links_multihost, and process 0 saves the merged matrices.
"""

import os
import sys


def main():
    coord, nprocs, pid, data_dir, out_npz = sys.argv[1:6]
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ.setdefault(
        "XLA_FLAGS", "--xla_force_host_platform_device_count=2")
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import jax
    jax.config.update("jax_platforms", "cpu")

    import numpy as np

    from vstrains_tpu.parallel.distributed import (
        host_read_stripe, infer_pe_links_multihost, init_distributed)

    init_distributed(coordinator_address=coord,
                     num_processes=int(nprocs), process_id=int(pid))

    k = 21
    index2id, index2seq = [], []
    gfa = os.path.join(data_dir,
                       "assembly_graph_after_simplification.gfa")
    with open(gfa) as fh:
        for line in fh:
            fields = line.rstrip("\n").split("\t")
            if fields and fields[0] == "S":
                index2id.append(fields[1])
                index2seq.append(fields[2])

    stripe = host_read_stripe(
        os.path.join(data_dir, "reads_1.fastq"),
        os.path.join(data_dir, "reads_2.fastq"),
        k + 1, jax.process_index(), jax.process_count())
    res = infer_pe_links_multihost(index2id, index2seq, stripe, k,
                                   batch_size=256)
    # large-N path: the sparse COO engine with per-host COO cross-host merge
    from vstrains_tpu.parallel.distributed import \
        infer_pe_links_sparse_multihost
    sres = infer_pe_links_sparse_multihost(index2id, index2seq, stripe,
                                           k, batch_size=256)
    if jax.process_index() == 0:
        np.savez(out_npz, node_mat=res.node_mat,
                 short_mat=res.short_mat,
                 pair_keys=sres.pair_keys, pair_counts=sres.pair_counts,
                 short_keys=sres.short_keys,
                 short_counts=sres.short_counts)
    return 0


if __name__ == "__main__":
    sys.exit(main())
