#!/usr/bin/env python3
"""50k-shape roofline decomposition.

Measures the three components of the large-N engine wall separately on
the live device so the E2E number can be judged against its floor:

  device_only   — 64 batches dispatched against ONE device-resident
                  wire buffer, single head pull at the end: pure device
                  compute rate (no per-batch transfers).
  h2d_rate      — device_put of the full 76 MB wire stream.
  d2h_rate      — pull of 64 head-sized results.

Env: R50K_NODES, R50K_BS, R50K_STRIDE (8), ROOF_OUT.
"""

import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main():
    n_nodes = int(os.environ.get("R50K_NODES", 50_000))
    bs = int(os.environ.get("R50K_BS", 16384))
    stride = int(os.environ.get("R50K_STRIDE", 8))
    n_batches = int(os.environ.get("ROOF_BATCHES", 64))
    os.environ["VSTRAINS_SORTFILL_STRIDE"] = str(stride)

    import jax
    import jax.numpy as jnp
    from bench import synth_workload
    from vstrains_tpu.core.fastq import _pack
    from vstrains_tpu.ops.pe_infer import (_build_sortfill_payloads,
                                           _pack_wire_np,
                                           _sortfill_node_bits,
                                           _stats_sparse_sortfill_wire,
                                           _wire_width,
                                           build_kmer_table)

    rec = {"backend": jax.default_backend(), "nodes": n_nodes,
           "bs": bs, "stride": stride, "n_batches": n_batches}
    refs, fwd, rve, k = synth_workload(n_nodes=n_nodes, n_pairs=bs,
                                       node_len=200)
    fc, fl = _pack([s.encode() for s in fwd])
    rc, rl = _pack([s.encode() for s in rve])
    T = max(fc.shape[1], rc.shape[1])
    wire_np = _pack_wire_np(fc, fl, rc, rl, T)
    tbl = build_kmer_table(refs, k + 1)
    node_bits = _sortfill_node_bits(n_nodes)
    pays = jnp.asarray(_build_sortfill_payloads(tbl, node_bits))
    tab_h1 = jnp.asarray(tbl.h1_biased)
    seq_lens = jnp.asarray(tbl.seq_lens)
    depth = int(pays.shape[1])
    kw = dict(T=T, split_len=k + 1, depth=depth, cap=16,
              num_nodes=n_nodes, fill="cummin", node_bits=node_bits,
              stride=stride)

    wire_dev = jax.device_put(wire_np)
    jax.block_until_ready(wire_dev)
    # warm (compile or cache load)
    t0 = time.time()
    out = _stats_sparse_sortfill_wire(wire_dev, tab_h1, seq_lens, pays,
                                      **kw)
    np.asarray(out[0])
    rec["warmup_s"] = round(time.time() - t0, 1)

    # device-only: dispatch n_batches against the resident buffer, pull
    # one head at the end (scalar materialization syncs the stream)
    t0 = time.time()
    for _ in range(n_batches):
        out = _stats_sparse_sortfill_wire(wire_dev, tab_h1, seq_lens,
                                          pays, **kw)
    np.asarray(out[0])
    dt = time.time() - t0
    rec["device_only_s"] = round(dt, 2)
    rec["device_only_reads_per_s"] = round(n_batches * bs / dt, 1)

    # H2D: the full wire stream as separate per-batch transfers
    wires = [wire_np.copy() for _ in range(8)]
    t0 = time.time()
    devs = [jax.device_put(w) for w in wires]
    jax.block_until_ready(devs)
    dt = time.time() - t0
    mb = sum(w.nbytes for w in wires) / 1e6
    rec["h2d_mb_s"] = round(mb / dt, 1)
    rec["h2d_probe_mb"] = round(mb, 1)

    # D2H: head-sized pulls (two-tier head: (2bs+1, 5) int32)
    heads = [_stats_sparse_sortfill_wire(d, tab_h1, seq_lens, pays,
                                         **kw)[0] for d in devs]
    jax.block_until_ready(heads)
    t0 = time.time()
    for h in heads:
        np.asarray(h)
    dt = time.time() - t0
    mb = sum(h.size * 4 for h in heads) / 1e6
    rec["d2h_mb_s"] = round(mb / dt, 1)
    rec["d2h_probe_mb"] = round(mb, 1)

    wire_mb_total = wire_np.nbytes * n_batches / 1e6
    head_mb_total = heads[0].size * 4 * n_batches / 1e6
    floor = (n_batches * bs / rec["device_only_reads_per_s"]
             + wire_mb_total / rec["h2d_mb_s"]
             + head_mb_total / rec["d2h_mb_s"])
    rec["serial_floor_s"] = round(floor, 2)
    rec["serial_floor_reads_per_s"] = round(n_batches * bs / floor, 1)
    rec["wire_mb_total"] = round(wire_mb_total, 1)
    rec["head_mb_total"] = round(head_mb_total, 1)
    print(json.dumps(rec))
    out_path = os.environ.get("ROOF_OUT")
    if out_path:
        with open(out_path, "w") as f:
            json.dump(rec, f, indent=2)


if __name__ == "__main__":
    main()
