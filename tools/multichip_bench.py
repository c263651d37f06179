#!/usr/bin/env python3
"""Real-slice readiness kit (VERDICT r2 item 10): one command that
sweeps mesh shapes over every visible device, measures per-axis
reads/s, and checks bit-equality against the single-chip engine — so
when real multi-chip hardware appears, BASELINE.json's
"1 chip / 1 host / N hosts" row is a single invocation.

    # today: virtual 8-device CPU mesh
    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python tools/multichip_bench.py --out multichip_bench.json

    # on a real slice: just run it (devices come from jax.devices());
    # multi-host slices: launch under jax.distributed as usual
    python tools/multichip_bench.py --pairs 1000000

Output: one JSON object with, per mesh shape (data x model), sustained
reads/s, per-batch wall, and `bit_equal` vs the single-chip matrices.
Timing: one scalar materialization per repetition, warmup excluded.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np


def mesh_shapes(n: int):
    """All power-of-2 (data, model) factorizations of n, DP-pure
    through TP-pure."""
    shapes = []
    m = 1
    while m <= n:
        if n % m == 0:
            shapes.append((n // m, m))
        m *= 2
    return shapes


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--nodes", type=int, default=512)
    ap.add_argument("--node-len", type=int, default=400)
    ap.add_argument("--pairs", type=int, default=131072)
    ap.add_argument("--read-len", type=int, default=150)
    ap.add_argument("--batch", type=int, default=16384)
    ap.add_argument("--k", type=int, default=55)
    ap.add_argument("--engine", choices=("dense", "sparse"),
                    default="dense",
                    help="sparse = the large-N COO engine "
                         "(infer_pe_links_sparse_sharded)")
    args = ap.parse_args()

    if os.environ.get("JAX_PLATFORMS") == "cpu":
        import jax
        jax.config.update("jax_platforms", "cpu")
    import jax

    from bench import synth_workload
    from vstrains_tpu.core.fastq import ReadPairBatch, _pack
    from vstrains_tpu.ops.pe_infer import infer_pe_links
    from vstrains_tpu.parallel.mesh import (infer_pe_links_sharded,
                                            infer_pe_links_sparse_sharded,
                                            make_mesh)

    devs = jax.devices()
    n_dev = len(devs)
    print(f"# backend={jax.default_backend()} devices={n_dev} "
          f"hosts={jax.process_count()}", file=sys.stderr)

    refs, fwd, rve, k = synth_workload(
        n_nodes=args.nodes, node_len=args.node_len, n_pairs=args.pairs,
        read_len=args.read_len, k=args.k)
    fc, fl = _pack([s.encode() for s in fwd])
    rc, rl = _pack([s.encode() for s in rve])
    batch = ReadPairBatch(fc, fl, rc, rl, 0, 0, args.pairs)
    ids = [str(i) for i in range(args.nodes)]

    result = {
        "engine": args.engine,
        "backend": jax.default_backend(),
        "devices": n_dev,
        "hosts": jax.process_count(),
        "nodes": args.nodes,
        "pairs": args.pairs,
        "read_len": args.read_len,
        "k": args.k,
        "meshes": {},
    }

    # single-chip baseline (the bit-equality oracle + the "1 chip" row)
    stats_mode = "sparse" if args.engine == "sparse" else "auto"
    t0 = time.time()
    base = infer_pe_links(ids, refs, batch, k, batch_size=args.batch,
                          stats_mode=stats_mode)
    warm = time.time() - t0
    t0 = time.time()
    base = infer_pe_links(ids, refs, batch, k, batch_size=args.batch,
                          stats_mode=stats_mode)
    dt = time.time() - t0
    result["single_chip"] = {
        "reads_per_s": round(args.pairs / dt),
        "wall_s": round(dt, 2),
        "first_run_wall_s": round(warm, 2),
    }
    print(f"# single chip: {args.pairs / dt:,.0f} reads/s",
          file=sys.stderr)

    for data, model in mesh_shapes(n_dev):
        mesh = make_mesh(data=data, model=model, devices=devs)
        label = f"{data}x{model}"
        run = (infer_pe_links_sparse_sharded if args.engine == "sparse"
               else infer_pe_links_sharded)
        t0 = time.time()
        res = run(ids, refs, batch, k, mesh, batch_size=args.batch)
        warm = time.time() - t0
        t0 = time.time()
        res = run(ids, refs, batch, k, mesh, batch_size=args.batch)
        dt = time.time() - t0
        if args.engine == "sparse":
            eq = (np.array_equal(res.pair_keys, base.pair_keys)
                  and np.array_equal(res.pair_counts, base.pair_counts)
                  and np.array_equal(res.short_keys, base.short_keys)
                  and np.array_equal(res.short_counts,
                                     base.short_counts))
        else:
            eq = (np.array_equal(res.node_mat, base.node_mat)
                  and np.array_equal(res.short_mat, base.short_mat))
        result["meshes"][label] = {
            "reads_per_s": round(args.pairs / dt),
            "wall_s": round(dt, 2),
            "first_run_wall_s": round(warm, 2),
            "bit_equal": bool(eq),
        }
        print(f"# mesh {label}: {args.pairs / dt:,.0f} reads/s, "
              f"bit_equal={eq}", file=sys.stderr)
        if not eq:
            result["meshes"][label]["error"] = "MATRICES DIFFER"

    ok = all(m["bit_equal"] for m in result["meshes"].values())
    result["all_bit_equal"] = ok
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(result, fh, indent=2)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
