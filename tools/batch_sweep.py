#!/usr/bin/env python3
"""E2E batch-size sweep on the headline bench workload (warm runs)."""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import jax


def main():
    from bench import synth_workload
    from vstrains_tpu.core.fastq import ReadPairBatch, _pack
    from vstrains_tpu.ops.pe_infer import infer_pe_links

    n_pairs = int(os.environ.get("SWEEP_PAIRS", 300_000))
    refs, fwd, rve, k = synth_workload(n_pairs=n_pairs)
    fc, fl = _pack([s.encode() for s in fwd])
    rc, rl = _pack([s.encode() for s in rve])
    batch = ReadPairBatch(fc, fl, rc, rl, 0, 0, n_pairs)
    ids = [str(i) for i in range(len(refs))]
    print(f"# backend: {jax.default_backend()}", file=sys.stderr)

    sizes = [int(x) for x in
             os.environ.get("SWEEP_SIZES", "8192,16384,32768").split(",")]
    for bs in sizes:
        warm = ReadPairBatch(fc[:bs], fl[:bs], rc[:bs], rl[:bs], 0, 0, bs)
        t0 = time.time()
        infer_pe_links(ids, refs, warm, k, batch_size=bs)
        tw = time.time() - t0
        best = None
        for _ in range(2):
            t0 = time.time()
            infer_pe_links(ids, refs, batch, k, batch_size=bs)
            dt = time.time() - t0
            best = dt if best is None else min(best, dt)
        print(f"batch={bs:6d}  warmup {tw:6.1f}s  "
              f"{n_pairs / best:9.0f} reads/s")


if __name__ == "__main__":
    main()
