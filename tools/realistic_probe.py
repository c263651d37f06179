#!/usr/bin/env python3
"""Per-variant compute probe at realistic scale (N~1k nodes, M~1M-entry
table, max_dup ~10): which stats/probe path should mid-size graphs take?

Like pe_profile2: pre-staged device inputs, scalar-reduced outputs,
deltas between timed loops are the per-stage costs.

    python tools/realistic_probe.py            # default device
    JAX_PLATFORMS=cpu python tools/realistic_probe.py
"""

import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

if os.environ.get("JAX_PLATFORMS") == "cpu":
    import jax
    jax.config.update("jax_platforms", "cpu")
import jax
import jax.numpy as jnp


@jax.jit
def _scalar(x):
    return jnp.sum(x.astype(jnp.float32))


def main():
    n_batches = int(os.environ.get("PROBE_BATCHES", 4))
    batch_size = int(os.environ.get("PROBE_BATCH", 16384))
    components = int(os.environ.get("PROBE_COMPONENTS", 32))
    print(f"# backend: {jax.default_backend()}", file=sys.stderr)

    from vstrains_tpu.core.fastq import load_read_pairs
    from vstrains_tpu.ops import pe_infer as P

    pairs = n_batches * batch_size + 2048
    k = 55
    split_len = k + 1
    if os.environ.get("PROBE_DATASET") == "bench":
        # the headline bench.py shape: random nodes (PROBE_NODES of
        # PROBE_NODE_LEN bp; defaults match bench.py)
        from bench import synth_workload
        from vstrains_tpu.core.fastq import ReadPairBatch, _pack
        index2seq, fwd_s, rve_s, k = synth_workload(
            n_nodes=int(os.environ.get("PROBE_NODES", 100)),
            node_len=int(os.environ.get("PROBE_NODE_LEN", 800)),
            n_pairs=pairs)
        split_len = k + 1
        fc, fl = _pack([s.encode() for s in fwd_s])
        rc, rl = _pack([s.encode() for s in rve_s])
        reads = ReadPairBatch(fc, fl, rc, rl, 0, 0, len(fwd_s))
    else:
        from tools.realistic_bench import build_dataset
        base = tempfile.mkdtemp(prefix="rprobe_")
        gfa, fwd, rve, n_nodes = build_dataset(base, components, pairs)
        index2seq = []
        with open(gfa) as fh:
            for line in fh:
                f = line.rstrip("\n").split("\t")
                if f and f[0] == "S":
                    index2seq.append(f[2])
        reads = load_read_pairs(fwd, rve, split_len, pad_to_multiple=32)
    table = P.build_kmer_table(index2seq, split_len)
    N = table.num_nodes
    print(f"# nodes={N} entries={table.num_entries} "
          f"max_dup={table.max_dup} scan_depth={table.scan_depth} "
          f"pairs={reads.num_pairs}", file=sys.stderr)

    tab_h1 = jnp.asarray(table.h1_biased)
    tab_h2 = jnp.asarray(table.h2)
    tab_node = jnp.asarray(table.node)
    seq_lens = jnp.asarray(table.seq_lens)

    staged = []
    for s in range(0, n_batches * batch_size, batch_size):
        e = s + batch_size
        codes, lens = P._stack_ends(
            jnp.asarray(reads.fwd_codes[s:e]),
            jnp.asarray(reads.fwd_len[s:e]),
            jnp.asarray(reads.rve_codes[s:e]),
            jnp.asarray(reads.rve_len[s:e]))
        codes.block_until_ready()
        staged.append((codes, lens))
    K = staged[0][0].shape[1] - split_len + 1
    cap = 16
    depth = table.max_dup

    variants = {}

    def v_join_classic(codes, lens):
        q1, h2qi, valid, lo = P._hash_join_kernel(codes, lens, tab_h1,
                                                  split_len=split_len)
        return _scalar(lo)

    variants["join_classic"] = v_join_classic

    def v_sparse_classic(codes, lens):
        q1, h2qi, valid, lo = P._hash_join_kernel(codes, lens, tab_h1,
                                                  split_len=split_len)
        _hd, sat = P._stats_sparse_kernel(
            q1, h2qi, valid, lo, lens, tab_h1, tab_h2, tab_node,
            seq_lens, split_len=split_len, depth=depth, cap=cap)
        return _scalar(sat) + _scalar(_hd[-1, 0])

    variants["sparse_classic"] = v_sparse_classic

    def v_dense_scatter(codes, lens):
        q1, h2qi, valid, lo = P._hash_join_kernel(codes, lens, tab_h1,
                                                  split_len=split_len)
        sat = P._stats_saturate_kernel(
            q1, h2qi, valid, lo, lens, tab_h1, tab_h2, tab_node,
            seq_lens, split_len=split_len, max_dup=depth, num_nodes=N,
            stats_impl="scatter")
        return _scalar(sat)

    variants["dense_scatter"] = v_dense_scatter

    node_bits = P._sortfill_node_bits(N)
    if node_bits is not None and table.max_dup <= P._SORTFILL_MAX_DUP:
        pays = jnp.asarray(P._build_sortfill_payloads(table, node_bits))
        D = int(pays.shape[1])

        def v_sparse_sortfill(codes, lens):
            _hd, sat = P._sparse_sortfill_core(
                codes, lens, tab_h1, seq_lens, pays, split_len,
                D, cap, N, "cummin", node_bits)
            return _scalar(sat) + _scalar(_hd[-1, 0])

        variants["sparse_sortfill"] = v_sparse_sortfill

        def v_sortfill_slots(codes, lens):
            node_t = P._sortfill_node_slots(
                codes, lens, tab_h1, pays, split_len, N,
                fill="cummin", node_bits=node_bits)
            return _scalar(node_t)

        variants["sortfill_slots_only"] = v_sortfill_slots

        def v_sortfill_onehot(codes, lens):
            node_t = P._sortfill_node_slots(
                codes, lens, tab_h1, pays, split_len, N,
                fill="cummin", node_bits=node_bits)
            cnt, kmin = P._slots_onehot_accum(node_t, D, N)
            sat = P._saturate(cnt, kmin, lens, seq_lens, split_len)
            B = codes.shape[0] // 2
            nm, sm = P._pair_matmuls(sat[:B], sat[B:], N)
            return _scalar(nm) + _scalar(sm)

        variants["dense_sortfill_onehot"] = v_sortfill_onehot

    only = os.environ.get("PROBE_VARIANTS")
    if only:
        keep = set(only.split(","))
        variants = {k: v for k, v in variants.items() if k in keep}
    for name, fn in variants.items():
        try:
            float(fn(*staged[0]))  # compile
            t0 = time.time()
            for codes, lens in staged:
                float(fn(codes, lens))
            dt = time.time() - t0
            per_batch = dt / len(staged) * 1000
            reads_s = len(staged) * batch_size / dt
            print(f"{name:26s} {per_batch:9.1f} ms/batch "
                  f"{reads_s:9.0f} reads/s")
        except Exception as exc:
            print(f"{name:26s} FAILED: {exc}")


if __name__ == "__main__":
    main()
