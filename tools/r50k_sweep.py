#!/usr/bin/env python3
"""Engine-only 50k sweep over the round-5 levers: batch size and
sortfill table stride (VERDICT r4 ask #3). Prints one JSON line per
config; best-of-2 engine walls with host canaries.

Env: SWEEP_CONFIGS like "16384:4,32768:4,32768:8,65536:4"
(bs:stride pairs), R50K_NODES, R50K_PAIRS.
"""

import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def canary():
    a = np.random.RandomState(0).randint(
        0, 2**31, size=20_000_000).astype(np.uint64)
    t0 = time.time()
    np.sort(a)
    return round(time.time() - t0, 2)


def main():
    n_nodes = int(os.environ.get("R50K_NODES", 50_000))
    n_pairs = int(os.environ.get("R50K_PAIRS", 1_048_576))
    configs = [c.split(":") for c in os.environ.get(
        "SWEEP_CONFIGS", "16384:4,32768:4,65536:4").split(",")]

    import jax
    from bench import synth_workload
    from vstrains_tpu.core.fastq import ReadPairBatch, _pack
    from vstrains_tpu.ops.pe_infer import build_kmer_table, infer_pe_links

    print(f"# backend={jax.default_backend()}", file=sys.stderr)
    refs, fwd, rve, k = synth_workload(n_nodes=n_nodes, n_pairs=n_pairs,
                                       node_len=200)
    ids = [str(i) for i in range(n_nodes)]
    fc, fl = _pack([s.encode() for s in fwd])
    rc, rl = _pack([s.encode() for s in rve])
    tbl = build_kmer_table(refs, k + 1)
    batch = ReadPairBatch(fc, fl, rc, rl, 0, 0, n_pairs)

    expected = None
    for bs_s, stride_s in configs:
        bs = int(bs_s)
        os.environ["VSTRAINS_SORTFILL_STRIDE"] = stride_s
        warm = ReadPairBatch(fc[:bs], fl[:bs], rc[:bs], rl[:bs], 0, 0,
                             bs)
        t0 = time.time()
        infer_pe_links(ids, refs, warm, k, batch_size=bs, table=tbl)
        warmup = round(time.time() - t0, 1)
        dts, cans = [], [canary()]
        res = None
        for _ in range(2):
            t0 = time.time()
            res = infer_pe_links(ids, refs, batch, k, batch_size=bs,
                                 table=tbl)
            dts.append(round(time.time() - t0, 2))
            cans.append(canary())
        key = (int(res.pair_keys.sum()), int(res.pair_counts.sum()),
               int(res.short_counts.sum()))
        if expected is None:
            expected = key
        assert key == expected, f"result drift at bs={bs}: {key}"
        dt = min(dts)
        print(json.dumps({
            "bs": bs, "stride": int(stride_s), "warmup_s": warmup,
            "engine_seconds": dt,
            "engine_reads_per_s": round(n_pairs / dt, 1),
            "reps_seconds": dts, "canary_s": cans,
        }))
        sys.stdout.flush()


if __name__ == "__main__":
    main()
