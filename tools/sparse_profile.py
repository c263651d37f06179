#!/usr/bin/env python3
"""Per-stage compute breakdown of the SPARSE (large-N) PE path.

Same method as pe_profile2.py: every variant consumes
pre-staged device-resident inputs and reduces to one scalar before the
loop materializes anything; cumulative deltas are the stage costs.

Variants (cumulative, sortfill probe):
  slots     sortfill probe -> node_t [B2, K*D]            -> sum
  sat       + row-sort sat tail (sort, scans, compaction) -> sum

Env: PROF_NODES (50000), PROF_BATCH (16384), PROF_NODE_LEN (200),
PROF_REPS (8).
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
from functools import partial


def main():
    n_nodes = int(os.environ.get("PROF_NODES", 50_000))
    B = int(os.environ.get("PROF_BATCH", 16384))
    node_len = int(os.environ.get("PROF_NODE_LEN", 200))
    reps = int(os.environ.get("PROF_REPS", 8))
    print(f"# backend: {jax.default_backend()} N={n_nodes} B={B}",
          file=sys.stderr)

    from bench import synth_workload
    from vstrains_tpu.core.fastq import _pack
    from vstrains_tpu.ops import pe_infer as P

    refs, fwd, rve, k = synth_workload(n_nodes=n_nodes, n_pairs=B,
                                       node_len=node_len)
    split_len = k + 1
    fc, fl = _pack([s.encode() for s in fwd])
    rc, rl = _pack([s.encode() for s in rve])

    t0 = time.time()
    tbl = P.build_kmer_table(refs, split_len)
    print(f"# table: {tbl.num_entries} entries, max_dup={tbl.max_dup}, "
          f"build {time.time() - t0:.1f}s", file=sys.stderr)

    node_bits = P._sortfill_node_bits(n_nodes)
    assert node_bits is not None and tbl.max_dup <= P._SORTFILL_MAX_DUP
    stride = P._sortfill_stride(tbl.num_entries)
    pays = jnp.asarray(P._build_sortfill_payloads(tbl, node_bits))
    D = int(pays.shape[1])
    tab_h1 = jnp.asarray(tbl.h1_biased)
    seq_lens = jnp.asarray(tbl.seq_lens)

    codes, lens = P._stack_ends(jnp.asarray(fc), jnp.asarray(fl),
                                jnp.asarray(rc), jnp.asarray(rl))
    codes = jax.device_put(codes)
    lens = jax.device_put(lens)
    cap = 16

    # tables MUST be jit arguments, not closure captures: captured they
    # become 232 MB of HLO constants
    @partial(jax.jit, static_argnames=("stride",))
    def v_slots(codes, lens, tab_h1, pays, salt, stride):
        node_t = P._sortfill_node_slots(
            codes + salt - salt, lens, tab_h1, pays, split_len,
            n_nodes, fill="cummin", node_bits=node_bits, stride=stride)
        return jnp.sum(node_t.astype(jnp.float32))

    @partial(jax.jit, static_argnames=("stride",))
    def v_sat(codes, lens, tab_h1, pays, salt, stride):
        _hd, out = P._sparse_sortfill_core(
            codes + salt - salt, lens, tab_h1, seq_lens, pays,
            split_len, D, cap, n_nodes, "cummin", node_bits,
            stride=stride)
        return (jnp.sum(out.astype(jnp.float32))
                + _hd[-1, 0].astype(jnp.float32))

    def timed(f, *a, stride=stride):
        float(f(*a, tab_h1, pays, jnp.int32(0), stride=stride))  # compile
        t0 = time.time()
        for r in range(reps):
            float(f(*a, tab_h1, pays, jnp.int32(r), stride=stride))
        return (time.time() - t0) / reps * 1000

    K = codes.shape[1] - split_len + 1
    print(f"# K={K} D={D} R={K * D} B2={codes.shape[0]} stride={stride}",
          file=sys.stderr)

    t_slots = timed(v_slots, codes, lens)
    t_sat = timed(v_sat, codes, lens)
    print(f"slots(probe) {t_slots:8.2f} ms")
    print(f"+sat tail    {t_sat:8.2f} ms  (tail = {t_sat - t_slots:.2f})")
    for s in (1, 8) if stride not in (1, 8) else (2,):
        t1 = timed(v_slots, codes, lens, stride=s)
        t2 = timed(v_sat, codes, lens, stride=s)
        print(f"stride={s}: slots {t1:8.2f} ms, full {t2:8.2f} ms")


if __name__ == "__main__":
    main()
