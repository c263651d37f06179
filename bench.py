#!/usr/bin/env python3
"""Headline benchmark: PE-link inference throughput (reads/s/chip).

Needs a GPU: with no GPU it exits non-zero and prints no result.
Measures the device engine (ops/pe_infer) on a synthetic viral-graph
workload and compares against the reference algorithm's pure-Python
implementation (the hot loop of
/root/reference/utils/VStrains_PE_Inference.py, re-implemented in
tests/oracle_pe.py and timed on a subsample).

Prints ONE JSON line:
  {"metric": "pe_reads_per_s_per_chip", "value": N, "unit": "reads/s",
   "vs_baseline": ratio, "device": {...}}
"""

import json
import sys
import time

import numpy as np


def synth_workload(n_nodes=100, node_len=800, n_pairs=100_000,
                   read_len=150, k=55, seed=0):
    rng = np.random.RandomState(seed)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    refs = [bases[rng.randint(0, 4, node_len)].tobytes().decode()
            for _ in range(n_nodes)]
    # reads sampled from nodes; paired ends from (usually) distinct nodes
    which1 = rng.randint(0, n_nodes, size=n_pairs)
    which2 = rng.randint(0, n_nodes, size=n_pairs)
    pos1 = rng.randint(0, node_len - read_len, size=n_pairs)
    pos2 = rng.randint(0, node_len - read_len, size=n_pairs)
    fwd = [refs[w][p: p + read_len] for w, p in zip(which1, pos1)]
    rve = [refs[w][p: p + read_len] for w, p in zip(which2, pos2)]
    return refs, fwd, rve, k


def main():
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py measures the GPU; JAX found {dev.platform}")
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    print(f"# device: {device}", file=sys.stderr)

    n_pairs = 1_000_000
    refs, fwd, rve, k = synth_workload(n_pairs=n_pairs)

    from vstrains_tpu.core.fastq import ReadPairBatch, _pack
    from vstrains_tpu.ops.pe_infer import infer_pe_links

    fc, fl = _pack([s.encode() for s in fwd])
    rc, rl = _pack([s.encode() for s in rve])
    batch = ReadPairBatch(fc, fl, rc, rl, 0, 0, len(fwd))
    ids = [str(i) for i in range(len(refs))]
    batch_size = 16384

    # warmup / compile on a small slice
    warm = ReadPairBatch(fc[:batch_size], fl[:batch_size],
                         rc[:batch_size], rl[:batch_size], 0, 0,
                         batch_size)
    infer_pe_links(ids, refs, warm, k, batch_size=batch_size)

    # best of 3, with every repetition reported beside it
    dts = []
    for _ in range(3):
        t0 = time.time()
        res = infer_pe_links(ids, refs, batch, k, batch_size=batch_size)
        dts.append(time.time() - t0)
    dt = min(dts)
    reads_per_s = n_pairs / dt
    print(f"# repetitions: {', '.join(f'{d:.2f}s' for d in dts)}",
          file=sys.stderr)

    # baseline: reference hot loop in pure Python on a subsample
    sys.path.insert(0, ".")
    from tests.oracle_pe import oracle_pe_matrices
    nb = 300
    t0 = time.time()
    oracle_pe_matrices(refs, fwd[:nb], rve[:nb], k)
    dt_base = time.time() - t0
    base_reads_per_s = nb / dt_base

    out = {
        "metric": "pe_reads_per_s_per_chip",
        "value": round(reads_per_s, 1),
        "unit": "reads/s",
        "vs_baseline": round(reads_per_s / base_reads_per_s, 2),
        # all repetitions, not just the headline best-of-3: a future
        # regression must not be able to hide behind one good rep
        "reps_seconds": [round(d, 2) for d in dts],
        "device": device,
    }
    print(json.dumps(out))
    # diagnostics on stderr (driver reads stdout JSON only)
    print(f"# engine: {n_pairs} pairs in {n_pairs / reads_per_s:.2f}s; "
          f"baseline(py): {base_reads_per_s:.1f} reads/s; "
          f"links={int(res.node_mat.sum())}", file=sys.stderr)


if __name__ == "__main__":
    main()
