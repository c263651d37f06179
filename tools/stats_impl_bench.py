#!/usr/bin/env python3
"""Time the two stats accumulators ('scatter', 'onehot') of the fused
PE batch, end to end through infer_pe_links, at two shapes:

  * hiv   — the simulated 5-strain HIV labmix graph (773 nodes), its
            388,928 pairs of 2x250 bp;
  * bench — bench.py's headline workload (100 nodes of 800 bp, 150 bp
            reads, k=55), 1,000,000 pairs.

Each shape compiles both variants first, then runs them in the order
scatter, onehot, onehot, scatter on the same table and reads, and
checks that both give the same matrices. Prints one JSON line with
every repetition and the device; needs a GPU.

    python3 tools/stats_impl_bench.py [--out chiprun_out/stats_impl.json]
"""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def time_impls(ids, seqs, reads, k, table):
    from vstrains_tpu.ops.pe_infer import STATS_IMPLS, infer_pe_links
    out = {impl: [] for impl in STATS_IMPLS}
    mats = {}
    for impl in STATS_IMPLS:  # compile
        os.environ["VSTRAINS_STATS_IMPL"] = impl
        res = infer_pe_links(ids, seqs, reads, k, table=table)
        mats[impl] = (res.node_mat, res.short_mat)
    a, b = mats.values()
    if not all(np.array_equal(x, y) for x, y in zip(a, b)):
        raise SystemExit("stats accumulators disagree")
    for impl in ("scatter", "onehot", "onehot", "scatter"):
        os.environ["VSTRAINS_STATS_IMPL"] = impl
        t0 = time.perf_counter()
        infer_pe_links(ids, seqs, reads, k, table=table)
        out[impl].append(time.perf_counter() - t0)
    os.environ.pop("VSTRAINS_STATS_IMPL")
    return out


def hiv_shape(work):
    from chip_smoke import read_gfa_segments
    from vstrains_tpu.core.fastq import load_read_pairs
    from vstrains_tpu.evals.hivsim import make_hiv_dataset
    ds = make_hiv_dataset(os.path.join(work, "hiv"), seed=0)
    ids, seqs = read_gfa_segments(ds.gfa_path)
    reads = load_read_pairs(ds.fwd_path, ds.rve_path, ds.k + 1,
                            pad_to_multiple=32)
    return ids, seqs, reads, ds.k


def bench_shape():
    from bench import synth_workload
    from vstrains_tpu.core.fastq import ReadPairBatch, _pack
    refs, fwd, rve, k = synth_workload(n_pairs=1_000_000)
    fc, fl = _pack([s.encode() for s in fwd])
    rc, rl = _pack([s.encode() for s in rve])
    return ([str(i) for i in range(len(refs))], refs,
            ReadPairBatch(fc, fl, rc, rl, 0, 0, len(fwd)), k)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"needs a GPU; JAX found {dev.platform}")
    from vstrains_tpu.ops.pe_infer import build_kmer_table
    rec = {"device": {"platform": dev.platform, "kind": dev.device_kind,
                      "count": len(jax.devices())}, "shapes": {}}
    with tempfile.TemporaryDirectory() as work:
        for name, make in (("hiv", lambda: hiv_shape(work)),
                           ("bench", bench_shape)):
            ids, seqs, reads, k = make()
            table = build_kmer_table(seqs, k + 1)
            T = max(reads.fwd_codes.shape[1], reads.rve_codes.shape[1])
            reps = time_impls(ids, seqs, reads, k, table)
            rec["shapes"][name] = {
                "nodes": len(ids), "pairs": int(reads.num_pairs),
                "width": int(T), "max_dup": int(table.max_dup),
                "seconds": reps}
            print(f"# {name}: {rec['shapes'][name]}", file=sys.stderr,
                  flush=True)
    print(json.dumps(rec))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(rec, fh, indent=1)


if __name__ == "__main__":
    main()
