#!/usr/bin/env python3
"""The reference's OTHER published benchmark shapes, both pipelines A/B.

Extends the HIV-labmix fidelity run (tools/hiv_fidelity.py) to the rest
of the reference's published evaluation surface
(/root/reference/README.md:204-211): the savage-benchmark simulated
mixtures 6-Polio / 10-HCV / 15-ZIKV at 20,000x total coverage and the
2-strain SARS-CoV-2 wastewater pair at 4,000x — simulated to shape by
evals/hivsim.make_benchmark_dataset (real genome lengths, random
phylogenies in each mixture's divergence regime, Illumina-shaped reads).

For each shape: generate the dataset once, run OUR pipeline (fresh
process through the CLI) and the ACTUAL reference (via shims/), score
both strain.fasta against the truth with the in-repo NGA50
(evals/nga50.py), and record per-strain rows like the HIV table
(VERDICT r4 ask #4).

Env: SHAPES (comma list, default all), SHAPE_COVERAGE (override for
quick runs), SHAPE_SEED (0), SHAPE_OUT (benchshapes.json),
SHAPE_SKIP_REF, SHAPE_REF_TIMEOUT (7200s per shape), SHAPE_WORKDIR.
"""

import json
import logging
import os
import shutil
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

from hiv_fidelity import run_ours_subprocess, run_reference, score  # noqa: E402


def main():
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(message)s",
                        stream=sys.stderr)
    from vstrains_tpu.evals.hivsim import BENCH_SHAPES, \
        make_benchmark_dataset

    shapes = [s for s in os.environ.get(
        "SHAPES", "polio6,hcv10,zikv15,sars2").split(",") if s]
    coverage = os.environ.get("SHAPE_COVERAGE")
    coverage = float(coverage) if coverage else None
    seed = int(os.environ.get("SHAPE_SEED", 0))
    out_json = os.environ.get("SHAPE_OUT",
                              os.path.join(REPO, "benchshapes.json"))
    skip_ref = os.environ.get("SHAPE_SKIP_REF", "") not in ("", "0")
    ref_timeout = float(os.environ.get("SHAPE_REF_TIMEOUT", 7200))
    workdir = os.environ.get("SHAPE_WORKDIR") or tempfile.mkdtemp(
        prefix="benchshapes_")
    os.makedirs(workdir, exist_ok=True)

    import jax
    results = {"backend": jax.default_backend(), "seed": seed,
               "shapes": {}}

    for shape in shapes:
        assert shape in BENCH_SHAPES, f"unknown shape {shape}"
        sdir = os.path.join(workdir, shape)
        t0 = time.time()
        data = make_benchmark_dataset(os.path.join(sdir, "data"), shape,
                                      seed=seed, coverage=coverage)
        rec = {
            "n_strains": len(data.true_haplotypes),
            "genomes": {n: len(s)
                        for n, s in data.true_haplotypes.items()},
            "identity": data.identity,
            "coverage": data.stats["coverage"],
            "read_pairs": data.n_pairs,
            "graph": data.stats,
            "dataset_gen_seconds": round(time.time() - t0, 1),
        }
        print(f"# {shape}: {rec['graph']} pairs={rec['read_pairs']} "
              f"identity={rec['identity']}", file=sys.stderr)

        ours_dir = os.path.join(sdir, "ours")
        wall, timings = run_ours_subprocess(data, ours_dir)
        rec["ours_wall_seconds"] = round(wall, 1)
        rec["ours_stages"] = {s["stage"]: s["seconds"]
                              for s in timings["stages"]}
        rec["ours"] = score(os.path.join(ours_dir, "strain.fasta"),
                            data.truth_path)
        print(f"# {shape} ours: {rec['ours_wall_seconds']}s "
              f"{rec['ours']['strains_recovered']} "
              f"mean_nga50={rec['ours']['mean_nga50']}", file=sys.stderr)

        if skip_ref:
            rec["reference"] = "skipped (SHAPE_SKIP_REF)"
        else:
            ref_dir = os.path.join(sdir, "ref")
            t0 = time.time()
            try:
                run_reference(data, ref_dir, ref_timeout)
                rec["reference_wall_seconds"] = round(time.time() - t0, 1)
                rec["reference"] = score(
                    os.path.join(ref_dir, "strain.fasta"),
                    data.truth_path)
                rec["speedup"] = round(rec["reference_wall_seconds"]
                                       / rec["ours_wall_seconds"], 1)
                print(f"# {shape} reference: "
                      f"{rec['reference_wall_seconds']}s "
                      f"{rec['reference']['strains_recovered']} "
                      f"mean_nga50={rec['reference']['mean_nga50']}",
                      file=sys.stderr)
            except Exception as exc:  # timeout or crash: record honestly
                rec["reference"] = f"FAILED: {exc}"[:500]
                rec["reference_wall_seconds"] = round(time.time() - t0, 1)
                print(f"# {shape} reference FAILED after "
                      f"{rec['reference_wall_seconds']}s: {exc}",
                      file=sys.stderr)

        results["shapes"][shape] = rec
        # checkpoint after every shape so a crash keeps earlier rows
        with open(out_json, "w") as f:
            json.dump(results, f, indent=2)
        shutil.rmtree(sdir, ignore_errors=True)

    print(json.dumps(results))
    print(f"# wrote {out_json}", file=sys.stderr)
    if os.environ.get("SHAPE_KEEP_WORKDIR", "") in ("", "0") \
            and workdir.startswith(tempfile.gettempdir()):
        shutil.rmtree(workdir, ignore_errors=True)


if __name__ == "__main__":
    main()
