#!/usr/bin/env python3
"""Adversarial-topology recovery frontier (VERDICT r2 item 9).

Sweeps the three axes the staggered-abundance soaks never stressed and
records where exact recovery first degrades:

  * near-equal abundance pairs      (2 strains, ratio -> 1.0)
  * shared-segment ratio            (anchor/variant length -> 98%)
  * nested bubbles                  (group fork -> strain fork), with
    staggered and near-equal abundances

Each config runs the FULL pipeline on the CPU backend (tiny graphs)
and scores exact-haplotype recovery. Output: JSON + a markdown table
for a report.

    JAX_PLATFORMS=cpu python tools/adversarial_soak.py --out frontier.json
"""

import argparse
import json
import logging
import os
import shutil
import sys
import tempfile
from types import SimpleNamespace

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def run_config(name, make, kwargs, seeds=(0, 1, 2)):
    """Run the pipeline on `make(**kwargs)` for several seeds; return
    per-seed (recovered, total)."""
    from vstrains_tpu import pipeline

    rows = []
    for seed in seeds:
        base = tempfile.mkdtemp(prefix="adv_")
        try:
            ds = make(os.path.join(base, "data"), seed=seed, **kwargs)
            out = os.path.join(base, "out")
            for sub in ("gfa", "tmp", "paf", "aln"):
                os.makedirs(os.path.join(out, sub))
            args = SimpleNamespace(
                gfa_file=ds.gfa_path, path_file=ds.paths_path,
                fwd=ds.fwd_path, rve=ds.rve_path, output_dir=out,
                min_cov=None, min_len=250, dev=False,
                pe_batch_size=1024, resume=False)
            try:
                pipeline.run(args, logging.getLogger("adv"))
                recs = open(os.path.join(out, "strain.fasta")
                            ).read().split(">")[1:]
                got = {"".join(r.splitlines()[1:]) for r in recs}
            except Exception as exc:  # noqa: BLE001 — a crash IS a result
                print(f"#   {name} seed={seed}: CRASH {exc}",
                      file=sys.stderr)
                got = set()
            hits = sum(1 for h in ds.true_haplotypes if h in got)
            rows.append((hits, len(ds.true_haplotypes), len(got)))
        finally:
            shutil.rmtree(base, ignore_errors=True)
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--pairs", type=int, default=800)
    args = ap.parse_args()
    import jax
    if os.environ.get("JAX_PLATFORMS") == "cpu":
        jax.config.update("jax_platforms", "cpu")

    from vstrains_tpu.evals.synth import (make_adversarial_dataset,
                                          make_dataset)

    results = {"backend": jax.default_backend(), "axes": {}}

    # ---- axis 1: near-equal abundance pair ----
    axis = []
    for ratio in (2.0, 1.5, 1.3, 1.2, 1.1, 1.05, 1.02, 1.0):
        rows = run_config(
            f"abundance x{ratio}", make_dataset,
            dict(num_strains=2, num_bubbles=3, contig_mode="split",
                 pairs_per_strain=args.pairs,
                 abundances=(100.0, 100.0 * ratio)))
        axis.append({"ratio": ratio, "runs": rows})
        print(f"# abundance ratio {ratio}: {rows}", file=sys.stderr)
    results["axes"]["near_equal_abundance"] = axis

    # ---- axis 2: shared-segment ratio ----
    axis = []
    for anchor in (120, 300, 500, 900, 1500, 2500):
        # shared fraction per haplotype ~ 4A / (4A + 3V), V ~ 120
        shared = 4 * anchor / (4 * anchor + 3 * 120)
        rows = run_config(
            f"shared {shared:.0%}", make_dataset,
            dict(num_strains=3, num_bubbles=3, contig_mode="split",
                 anchor_len=anchor, pairs_per_strain=args.pairs,
                 abundances=(40.0, 70.0, 100.0)))
        axis.append({"anchor_len": anchor,
                     "shared_pct": round(100 * shared, 1),
                     "runs": rows})
        print(f"# shared {shared:.0%}: {rows}", file=sys.stderr)
    results["axes"]["shared_segment_ratio"] = axis

    # ---- axis 3: nested bubbles ----
    axis = []
    for label, ab in (("staggered", (20.0, 60.0, 110.0, 170.0)),
                      ("mild", (40.0, 60.0, 85.0, 115.0)),
                      ("near-equal", (90.0, 100.0, 110.0, 121.0))):
        for nested_every in (0, 2, 1):
            rows = run_config(
                f"nested/{nested_every} {label}",
                make_adversarial_dataset,
                dict(num_strains=4, num_bubbles=4,
                     nested_every=nested_every,
                     pairs_per_strain=args.pairs, abundances=ab))
            axis.append({"abundances": label,
                         "nested_every": nested_every, "runs": rows})
            print(f"# nested_every={nested_every} {label}: {rows}",
                  file=sys.stderr)
    results["axes"]["nested_bubbles"] = axis

    # markdown frontier table
    lines = ["| axis | setting | recovered (3 seeds) |",
             "|---|---|---|"]
    for ax, entries in results["axes"].items():
        for e in entries:
            setting = ", ".join(f"{k}={v}" for k, v in e.items()
                                if k != "runs")
            rec = "; ".join(f"{h}/{t}" for h, t, _ in e["runs"])
            lines.append(f"| {ax} | {setting} | {rec} |")
    results["markdown"] = "\n".join(lines)
    print(results["markdown"])
    print(json.dumps({ax: entries for ax, entries in
                      results["axes"].items()}))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(results, fh, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
