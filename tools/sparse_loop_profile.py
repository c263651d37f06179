#!/usr/bin/env python3
"""Phase breakdown of the sparse large-N engine loop at N=50k.

Replays _infer_pe_links_sparse's exact structure with stage timers:
  pack     — host wire packing (_wire_batches body)
  dispatch — kernel dispatch call (async; returns before compute)
  sync     — blocking np.asarray of the last result (device+transfer)
  drain    — host COO pair expansion + unique (what the worker thread
             does, measured synchronously here for attribution)

Env: PROF_NODES (50000), PROF_PAIRS (262144), PROF_BATCH (16384).
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import jax
import jax.numpy as jnp


def main():
    n_nodes = int(os.environ.get("PROF_NODES", 50_000))
    n_pairs = int(os.environ.get("PROF_PAIRS", 262_144))
    bs = int(os.environ.get("PROF_BATCH", 16_384))
    from bench import synth_workload
    from vstrains_tpu.core.fastq import ReadPairBatch, _pack
    from vstrains_tpu.ops.pe_infer import (
        _build_sortfill_payloads, _sortfill_node_bits, _sortfill_stride,
        _sparse_pairs_np, _stats_sparse_sortfill_wire, _wire_batches,
        build_kmer_table)

    print(f"# backend={jax.default_backend()} N={n_nodes} "
          f"pairs={n_pairs} B={bs}", file=sys.stderr)
    refs, fwd, rve, k = synth_workload(n_nodes=n_nodes, n_pairs=n_pairs,
                                       node_len=200)
    fc, fl = _pack([s.encode() for s in fwd])
    rc, rl = _pack([s.encode() for s in rve])
    reads = ReadPairBatch(fc, fl, rc, rl, 0, 0, n_pairs)
    split_len = k + 1

    t0 = time.time()
    table = build_kmer_table(refs, split_len)
    print(f"# table build: {time.time() - t0:.1f}s", file=sys.stderr)
    N = table.num_nodes
    node_bits = _sortfill_node_bits(N)
    stride = _sortfill_stride(table.num_entries)
    pays = jnp.asarray(_build_sortfill_payloads(table, node_bits))
    tab_h1 = jnp.asarray(table.h1_biased)
    seq_lens = jnp.asarray(table.seq_lens)
    T = max(fc.shape[1], rc.shape[1])
    depth = int(pays.shape[1])

    def dispatch(wire_dev):
        return _stats_sparse_sortfill_wire(
            wire_dev, tab_h1, seq_lens, pays, T=T, split_len=split_len,
            depth=depth, cap=16, num_nodes=N, fill="cummin",
            node_bits=node_bits, stride=stride)

    # warm
    for kind, payload in _wire_batches(
            ReadPairBatch(fc[:bs], fl[:bs], rc[:bs], rl[:bs], 0, 0, bs),
            bs):
        assert kind == "wire"
        hd, sat = dispatch(payload)
        np.asarray(sat)

    acc = {"pack+h2d": 0.0, "dispatch": 0.0, "sync": 0.0, "drain": 0.0}
    t_all = time.time()
    n_batches = 0
    # serialized phases (no thread overlap) for clean attribution
    gen = _wire_batches(reads, bs)
    while True:
        t0 = time.time()
        item = next(gen, None)
        acc["pack+h2d"] += time.time() - t0
        if item is None:
            break
        kind, payload = item
        assert kind == "wire"
        t0 = time.time()
        hd, sat = dispatch(payload)
        acc["dispatch"] += time.time() - t0
        t0 = time.time()
        sn = np.asarray(sat)
        acc["sync"] += time.time() - t0
        t0 = time.time()
        b = sn.shape[0] // 2
        pe, st = _sparse_pairs_np(sn[:b], sn[b:], N)
        for arr in (pe, st):
            np.unique(arr, return_counts=True)
        acc["drain"] += time.time() - t0
        n_batches += 1
    wall = time.time() - t_all
    per = {p: round(1e3 * v / n_batches, 1) for p, v in acc.items()}
    print(f"# {n_batches} batches, serialized wall {wall:.1f}s "
          f"({n_pairs / wall:,.0f} reads/s)", file=sys.stderr)
    print(f"# per-batch ms: {per}", file=sys.stderr)
    print(f"# unattributed ms/batch: "
          f"{1e3 * (wall - sum(acc.values())) / n_batches:.1f}",
          file=sys.stderr)


if __name__ == "__main__":
    main()
