#!/usr/bin/env python3
"""Per-stage wall-time breakdown of the PE engine on the bench workload.

Every number here is an end-to-end loop over all batches with
materialized outputs (np.asarray), so no timing stops at the enqueue.

Stages timed cumulatively (each variant runs the pipeline up to stage X):
  hash_join    window hashes + sort-merge join            -> lo
  stats        + duplicate-scan stats + saturation        -> sat
  full         + pair matmuls + accumulate                -> matrices
  e2e          infer_pe_links (incl. host loop, padding, spill)
"""

import json
import os
import sys
import time

import numpy as np


sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import jax
import jax.numpy as jnp


def main():
    n_pairs = int(os.environ.get("PROF_PAIRS", 300_000))
    batch_size = int(os.environ.get("PROF_BATCH", 16384))
    n_nodes = int(os.environ.get("PROF_NODES", 100))
    print(f"# backend: {jax.default_backend()}", file=sys.stderr)

    from bench import synth_workload
    from vstrains_tpu.core.fastq import ReadPairBatch, _pack
    from vstrains_tpu.ops import pe_infer as P

    refs, fwd, rve, k = synth_workload(n_nodes=n_nodes, n_pairs=n_pairs)
    split_len = k + 1
    fc, fl = _pack([s.encode() for s in fwd])
    rc, rl = _pack([s.encode() for s in rve])

    t0 = time.time()
    table = P.build_kmer_table(refs, split_len)
    t_table = time.time() - t0
    N = table.num_nodes
    print(f"# table: {table.num_entries} entries max_dup={table.max_dup} "
          f"build={t_table:.2f}s", file=sys.stderr)

    tab = (jnp.asarray(table.h1_biased), jnp.asarray(table.h2),
           jnp.asarray(table.node), jnp.asarray(table.seq_lens))
    tab_h1, tab_h2, tab_node, seq_lens = tab

    def batches():
        B = len(fwd)
        for start in range(0, B, batch_size):
            end = min(start + batch_size, B)
            if end - start < batch_size:
                break  # profiling: full batches only
            f = jnp.asarray(fc[start:end])
            flen = jnp.asarray(fl[start:end])
            r = jnp.asarray(rc[start:end])
            rlen = jnp.asarray(rl[start:end])
            yield P._stack_ends(f, flen, r, rlen)

    def run_variant(name, fn, warm_args):
        # warmup/compile
        out = fn(*warm_args)
        jax.tree_util.tree_map(
            lambda x: x.block_until_ready() if hasattr(
                x, "block_until_ready") else x, out)
        t0 = time.time()
        count = 0
        for codes, lens in batches():
            out = fn(codes, lens)
            count += 1
        jax.tree_util.tree_map(
            lambda x: np.asarray(x) if hasattr(
                x, "block_until_ready") else x, out)
        dt = time.time() - t0
        per_batch = dt / count * 1000
        reads = count * batch_size / dt
        print(f"{name:12s} {dt:7.2f}s  {per_batch:8.2f} ms/batch  "
              f"{reads:10.0f} reads/s")
        return dt

    first = next(batches())
    K = first[0].shape[1] - split_len + 1

    def v_sort_stats(codes, lens):
        q1, h2qi, valid, lo = P._hash_join_kernel(codes, lens, tab_h1,
                                                  split_len=split_len)
        return P._stats_saturate_kernel(
            q1, h2qi, valid, lo, lens, tab_h1, tab_h2, tab_node,
            seq_lens, split_len=split_len, max_dup=table.max_dup,
            num_nodes=N,
            stats_impl=P._stats_impl_choice(N, K, table.max_dup))

    def v_full(codes, lens):
        q1, h2qi, valid, lo = P._hash_join_kernel(codes, lens, tab_h1,
                                                  split_len=split_len)
        sat = P._stats_saturate_kernel(
            q1, h2qi, valid, lo, lens, tab_h1, tab_h2, tab_node,
            seq_lens, split_len=split_len, max_dup=table.max_dup,
            num_nodes=N,
            stats_impl=P._stats_impl_choice(N, K, table.max_dup))
        B = sat.shape[0] // 2
        return P._pair_matmuls_jit(sat[:B], sat[B:], num_nodes=N)

    run_variant("sort_stats", v_sort_stats, first)
    run_variant("full", v_full, first)

    # e2e through infer_pe_links (host loop incl. padding + spill)
    ids = [str(i) for i in range(len(refs))]
    batch = ReadPairBatch(fc, fl, rc, rl, 0, 0, len(fwd))
    t0 = time.time()
    res = P.infer_pe_links(ids, refs, batch, k, batch_size=batch_size)
    dt = time.time() - t0
    print(f"{'e2e':12s} {dt:7.2f}s  "
          f"{dt / (len(fwd) / batch_size) * 1000:8.2f} ms/batch  "
          f"{len(fwd) / dt:10.0f} reads/s  "
          f"links={int(res.node_mat.sum())}")


if __name__ == "__main__":
    main()
