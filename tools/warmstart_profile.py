#!/usr/bin/env python3
"""Fine-grained fresh-process warm-start timeline for the 50k shape.

This probe stamps every phase of a fresh process so its warm-start
wall decomposes into actionable pieces:

  import_jax        — jax import + backend attach
  first_device_op   — trivial jnp op (device handshake + tiny compile)
  synth             — host dataset synthesis (bs pairs only)
  table_build       — host k-mer table build
  payload_build     — host sortfill payload matrix build
  payload_h2d       — payload + table H2D (the one-time ~174 MB)
  first_dispatch    — first sparse batch (cache load / compile + run)
  second_dispatch   — steady-state batch (the per-batch floor)

Prints one JSON line with all phases. Run after tools/realistic_50k.py
has populated the cache (same shapes).

Env: R50K_NODES (50000), R50K_BS (16384), WSP_OUT.
"""

import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main():
    n_nodes = int(os.environ.get("R50K_NODES", 50_000))
    bs = int(os.environ.get("R50K_BS", 16384))
    phases = {}
    t_origin = time.time()

    def stamp(name, t0):
        phases[name] = round(time.time() - t0, 2)
        print(f"# {name}: {phases[name]}s (t+{time.time() - t_origin:.1f})",
              file=sys.stderr)

    t0 = time.time()
    import jax
    import jax.numpy as jnp
    from vstrains_tpu.utils.jaxcache import enable_persistent_cache
    enable_persistent_cache()
    backend = jax.default_backend()
    stamp("import_jax", t0)

    t0 = time.time()
    float(jnp.ones(8).sum())
    stamp("first_device_op", t0)

    t0 = time.time()
    from bench import synth_workload
    from vstrains_tpu.core.fastq import ReadPairBatch, _pack
    from vstrains_tpu.ops.pe_infer import (_build_sortfill_payloads,
                                           _sortfill_node_bits,
                                           _sortfill_stride,
                                           _stats_sparse_sortfill,
                                           build_kmer_table)
    refs, fwd, rve, k = synth_workload(n_nodes=n_nodes, n_pairs=bs,
                                       node_len=200)
    fc, fl = _pack([s.encode() for s in fwd])
    rc, rl = _pack([s.encode() for s in rve])
    stamp("synth", t0)

    t0 = time.time()
    tbl = build_kmer_table(refs, k + 1)
    stamp("table_build", t0)

    node_bits = _sortfill_node_bits(n_nodes)
    t0 = time.time()
    pays_np = _build_sortfill_payloads(tbl, node_bits)
    stamp("payload_build", t0)

    t0 = time.time()
    pays = jax.device_put(pays_np)
    tab_h1 = jax.device_put(tbl.h1_biased)
    seq_lens = jax.device_put(tbl.seq_lens)
    jax.block_until_ready((pays, tab_h1, seq_lens))
    stamp("payload_h2d", t0)
    phases["payload_mb"] = round(pays_np.nbytes / 1e6, 1)

    stride = _sortfill_stride(tbl.num_entries)
    depth = int(pays_np.shape[1])
    args = dict(split_len=k + 1, depth=depth, cap=16,
                num_nodes=n_nodes, fill="cummin", node_bits=node_bits,
                stride=stride)

    t0 = time.time()
    out = _stats_sparse_sortfill(jnp.asarray(fc), jnp.asarray(fl),
                                 jnp.asarray(rc), jnp.asarray(rl),
                                 tab_h1, seq_lens, pays, **args)
    np_head = __import__("numpy").asarray(out[0])
    stamp("first_dispatch", t0)

    t0 = time.time()
    out = _stats_sparse_sortfill(jnp.asarray(fc), jnp.asarray(fl),
                                 jnp.asarray(rc), jnp.asarray(rl),
                                 tab_h1, seq_lens, pays, **args)
    np_head = __import__("numpy").asarray(out[0])
    stamp("second_dispatch", t0)

    phases["total_seconds"] = round(time.time() - t_origin, 2)
    phases["backend"] = backend
    phases["nodes"] = n_nodes
    phases["batch"] = bs
    print(json.dumps(phases))
    out_path = os.environ.get("WSP_OUT")
    if out_path:
        with open(out_path, "w") as f:
            json.dump(phases, f, indent=2)


if __name__ == "__main__":
    main()
