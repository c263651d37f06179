#!/usr/bin/env python3
"""Per-stage compute breakdown of the PE engine.

So that result transfers never overlap the loop's timing, every
variant here (a) consumes pre-staged device-resident inputs and
(b) reduces its output to one scalar on device before the loop
materializes anything. The deltas between cumulative variants are the
per-stage compute costs.

Variants (cumulative):
  hash_join   window hashes + sort-merge join          -> sum(lo)
  stats       + duplicate-scan stats + saturation      -> sum(sat)
  full        + pair matmuls                           -> sum(nm + sm)
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import jax
import jax.numpy as jnp


@jax.jit
def _scalar(x):
    return jnp.sum(x.astype(jnp.float32))


def main():
    n_pairs = int(os.environ.get("PROF_PAIRS", 300_000))
    batch_size = int(os.environ.get("PROF_BATCH", 16384))
    n_nodes = int(os.environ.get("PROF_NODES", 100))
    print(f"# backend: {jax.default_backend()}", file=sys.stderr)

    from bench import synth_workload
    from vstrains_tpu.core.fastq import _pack
    from vstrains_tpu.ops import pe_infer as P

    refs, fwd, rve, k = synth_workload(n_nodes=n_nodes, n_pairs=n_pairs)
    split_len = k + 1
    fc, fl = _pack([s.encode() for s in fwd])
    rc, rl = _pack([s.encode() for s in rve])

    table = P.build_kmer_table(refs, split_len)
    N = table.num_nodes
    print(f"# table: {table.num_entries} entries max_dup={table.max_dup}",
          file=sys.stderr)

    tab_h1 = jnp.asarray(table.h1_biased)
    tab_h2 = jnp.asarray(table.h2)
    tab_node = jnp.asarray(table.node)
    seq_lens = jnp.asarray(table.seq_lens)

    # pre-stage every full batch on device (transfer excluded from timing)
    staged = []
    B = len(fwd)
    for start in range(0, B, batch_size):
        end = start + batch_size
        if end > B:
            break
        codes, lens = P._stack_ends(
            jnp.asarray(fc[start:end]), jnp.asarray(fl[start:end]),
            jnp.asarray(rc[start:end]), jnp.asarray(rl[start:end]))
        codes.block_until_ready()
        staged.append((codes, lens))
    print(f"# staged {len(staged)} batches on device", file=sys.stderr)
    K = staged[0][0].shape[1] - split_len + 1

    def v_hash(codes, lens):
        q1, h2qi, valid, lo = P._hash_join_kernel(codes, lens, tab_h1,
                                                  split_len=split_len)
        return _scalar(lo)

    def v_stats(codes, lens):
        q1, h2qi, valid, lo = P._hash_join_kernel(codes, lens, tab_h1,
                                                  split_len=split_len)
        sat = P._stats_saturate_kernel(
            q1, h2qi, valid, lo, lens, tab_h1, tab_h2, tab_node,
            seq_lens, split_len=split_len, max_dup=table.max_dup,
            num_nodes=N,
            stats_impl=P._stats_impl_choice(N, K, table.max_dup))
        return _scalar(sat)

    def v_full(codes, lens):
        q1, h2qi, valid, lo = P._hash_join_kernel(codes, lens, tab_h1,
                                                  split_len=split_len)
        sat = P._stats_saturate_kernel(
            q1, h2qi, valid, lo, lens, tab_h1, tab_h2, tab_node,
            seq_lens, split_len=split_len, max_dup=table.max_dup,
            num_nodes=N,
            stats_impl=P._stats_impl_choice(N, K, table.max_dup))
        Bh = sat.shape[0] // 2
        nm, sm = P._pair_matmuls_jit(sat[:Bh], sat[Bh:], num_nodes=N)
        return _scalar(nm) + _scalar(sm)

    prev = 0.0
    for name, fn in (("hash_join", v_hash), ("stats", v_stats),
                     ("full", v_full)):
        float(fn(*staged[0]))  # warmup/compile, materialized
        t0 = time.time()
        acc = 0.0
        for codes, lens in staged:
            acc += float(fn(codes, lens))  # scalar sync per batch
        dt = time.time() - t0
        per_batch = dt / len(staged) * 1000
        reads = len(staged) * batch_size / dt
        print(f"{name:10s} {dt:7.2f}s  {per_batch:8.2f} ms/batch  "
              f"{reads:9.0f} reads/s  (+{per_batch - prev:.2f} ms stage)")
        prev = per_batch


if __name__ == "__main__":
    main()
