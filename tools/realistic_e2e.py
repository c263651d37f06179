#!/usr/bin/env python3
"""Full-pipeline E2E at metaSPAdes scale: the merged 32-component
realistic dataset (992 nodes, ~1M read pairs, one component with 10kb
anchors) through ALL pipeline stages via the CLI entry point, with
exact-haplotype recovery checked across every component.

    python tools/realistic_e2e.py --out realistic_e2e_r2_tpu.json
    JAX_PLATFORMS=cpu python tools/realistic_e2e.py --pairs 200000
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def merge_with_paths(base, n_components, pairs_total):
    """build_dataset's GFA/FASTQ merge plus a merged contigs.paths
    (node ids offset by 100000 per component, contig numbers renumbered
    globally) and the pooled true haplotypes."""
    from tools.realistic_bench import build_dataset

    gfa, fwd, rve, n_nodes, comps = build_dataset(
        base, n_components, pairs_total, return_comps=True)
    paths = os.path.join(base, "contigs.paths")
    haps = []
    cno = 1

    def renum_hdr(line):
        f = line.split("_")          # NODE_<cno>_length_<l>_cov_<c>[']
        f[1] = str(cno)
        return "_".join(f)

    def renum_nodes(line, ci):
        return ",".join(str(int(n[:-1]) + 100000 * ci) + n[-1]
                        for n in line.rstrip(";").split(","))

    with open(paths, "w") as out:
        for ci, ds in enumerate(comps):
            haps.extend(ds.true_haplotypes)
            lines = open(ds.paths_path).read().splitlines()
            for i in range(0, len(lines), 4):
                out.write(renum_hdr(lines[i]) + "\n")
                out.write(renum_nodes(lines[i + 1], ci) + "\n")
                out.write(renum_hdr(lines[i + 2]) + "\n")
                out.write(renum_nodes(lines[i + 3], ci) + "\n")
                cno += 1
    return gfa, paths, fwd, rve, n_nodes, haps


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--components", type=int, default=32)
    ap.add_argument("--pairs", type=int, default=1_000_000)
    args = ap.parse_args()

    if os.environ.get("JAX_PLATFORMS") == "cpu":
        import jax
        jax.config.update("jax_platforms", "cpu")
    import jax

    base = tempfile.mkdtemp(prefix="re2e_")
    result = {"backend": jax.default_backend()}
    try:
        t0 = time.time()
        gfa, paths, fwd, rve, n_nodes, haps = merge_with_paths(
            base, args.components, args.pairs)
        print(f"# dataset: {n_nodes} nodes, {len(haps)} true haplotypes,"
              f" built in {time.time() - t0:.1f}s", file=sys.stderr)
        result["nodes"] = n_nodes
        result["true_haplotypes"] = len(haps)

        out_dir = os.path.join(base, "out")
        from vstrains_tpu.cli import main as cli_main
        t0 = time.time()
        rc = cli_main(["-a", "spades", "-g", gfa, "-p", paths,
                       "-fwd", fwd, "-rve", rve, "-o", out_dir,
                       "--per-component"])
        result["wall_seconds"] = round(time.time() - t0, 1)
        result["exit_code"] = rc
        fa = open(os.path.join(out_dir, "strain.fasta")).read()
        seqs = ["".join(rec.splitlines()[1:])
                for rec in fa.split(">")[1:]]
        result["strains_out"] = len(seqs)
        got = set(seqs)
        result["recovered_exact"] = sum(1 for h in haps if h in got)
        tj = os.path.join(out_dir, "timings.json")
        if os.path.exists(tj):
            result["stages"] = json.load(open(tj))
    finally:
        shutil.rmtree(base, ignore_errors=True)

    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(result, fh, indent=2)
    return 0 if result.get("recovered_exact") == len(haps) else 1


if __name__ == "__main__":
    sys.exit(main())
