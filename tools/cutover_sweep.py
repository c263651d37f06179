#!/usr/bin/env python3
"""Dense-vs-sparse engine sweep across mid-N on the live backend.

The auto cutover routes to sparse when batch_size exceeds the
stats-memory budget (~N=3.8k at batch 16384). The round-5 two-phase
tail made sparse 1.7x faster, so the crossing may have moved — this
probes both engines at each N on identical inputs (results must be
equal; walls best-of-2).

Env: CUT_NS ("1000,2000,4000"), CUT_PAIRS (262144), CUT_BS (16384).
"""
import json, os, sys, time
import numpy as np
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

def main():
    ns = [int(x) for x in os.environ.get("CUT_NS",
                                         "1000,2000,4000").split(",")]
    n_pairs = int(os.environ.get("CUT_PAIRS", 262144))
    bs = int(os.environ.get("CUT_BS", 16384))
    import jax
    from bench import synth_workload
    from vstrains_tpu.core.fastq import ReadPairBatch, _pack
    from vstrains_tpu.ops.pe_infer import (PESparseResult,
                                           build_kmer_table,
                                           infer_pe_links)
    print(f"# backend={jax.default_backend()}", file=sys.stderr)
    for n in ns:
        refs, fwd, rve, k = synth_workload(n_nodes=n, n_pairs=n_pairs,
                                           node_len=200)
        fc, fl = _pack([s.encode() for s in fwd])
        rc, rl = _pack([s.encode() for s in rve])
        batch = ReadPairBatch(fc, fl, rc, rl, 0, 0, n_pairs)
        ids = [str(i) for i in range(n)]
        tbl = build_kmer_table(refs, k + 1)
        row = {"N": n, "pairs": n_pairs, "bs": bs}
        results = {}
        for mode in ("dense", "sparse"):
            warm = ReadPairBatch(fc[:bs], fl[:bs], rc[:bs], rl[:bs],
                                 0, 0, bs)
            t0 = time.time()
            infer_pe_links(ids, refs, warm, k, batch_size=bs,
                           stats_mode=mode, table=tbl)
            row[f"{mode}_warmup_s"] = round(time.time() - t0, 1)
            best = 1e9
            for _ in range(2):
                t0 = time.time()
                res = infer_pe_links(ids, refs, batch, k, batch_size=bs,
                                     stats_mode=mode, table=tbl)
                best = min(best, time.time() - t0)
            row[f"{mode}_reads_per_s"] = round(n_pairs / best, 1)
            if isinstance(res, PESparseResult):
                m = np.zeros((n, n), np.int64)
                m[res.pair_keys // n, res.pair_keys % n] = res.pair_counts
                results[mode] = m
            else:
                results[mode] = res.node_mat
        row["equal"] = bool(np.array_equal(results["dense"],
                                           results["sparse"]))
        print(json.dumps(row))
        sys.stdout.flush()

if __name__ == "__main__":
    main()
