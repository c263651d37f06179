#!/usr/bin/env python3
"""Decompose the HIV-shape PE stage.

Times each phase of the stage in isolation on the simulated HIV labmix:
graph stages, FASTQ load, table build, and two engine calls on the same
shape (the first pays the compile).

Env: HIV_COVERAGE (20000), HIV_SEED (0), HPP_OUT.
"""

import json
import logging
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main():
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    logger = logging.getLogger("hiv_pe_profile")
    coverage = float(os.environ.get("HIV_COVERAGE", 20000))
    seed = int(os.environ.get("HIV_SEED", 0))
    rec = {}

    import jax
    rec["backend"] = jax.default_backend()

    from vstrains_tpu.evals.hivsim import make_hiv_dataset
    workdir = tempfile.mkdtemp(prefix="hiv_pe_prof_")
    t0 = time.time()
    data = make_hiv_dataset(os.path.join(workdir, "data"),
                            coverage=coverage, seed=seed)
    rec["dataset_gen_s"] = round(time.time() - t0, 1)

    # pipeline stages 1-3 replay to get the exact simplified node set
    import numpy as np
    from vstrains_tpu.algos.preprocess import (graph_simplification,
                                               reindexing)
    from vstrains_tpu.core.canon import load_gfa_canonized
    from vstrains_tpu.core.contig_io import spades_paths_parser
    from vstrains_tpu.ops.graph_ops import threshold_estimation
    t0 = time.time()
    view = load_gfa_canonized(data.gfa_path, logger).compact()
    view, idx_mapping = reindexing(view)
    dps = np.array([v.dp for v in view.graph.vertices()])
    threshold = threshold_estimation(dps, logger)
    contig_dict, _ = spades_paths_parser(view, idx_mapping,
                                         data.paths_path, 250, threshold,
                                         logger)
    graph_simplification(view, None, threshold, logger)
    view1 = view.compact()
    ids = list(view1.nodes.keys())
    seqs = [view1.nodes[i].seq for i in ids]
    ksize = next(iter(view1.edges.values())).overlap
    rec["graph_stages_s"] = round(time.time() - t0, 1)
    rec["n_nodes"] = len(ids)
    rec["k"] = ksize

    from vstrains_tpu.core.fastq import load_read_pairs
    t0 = time.time()
    reads = load_read_pairs(data.fwd_path, data.rve_path, ksize + 1,
                            pad_to_multiple=32)
    rec["fastq_load_s"] = round(time.time() - t0, 1)
    rec["n_pairs"] = reads.num_pairs

    from vstrains_tpu.ops.pe_infer import build_kmer_table, infer_pe_links
    t0 = time.time()
    tbl = build_kmer_table(seqs, ksize + 1)
    rec["table_build_s"] = round(time.time() - t0, 1)
    rec["table_entries"] = tbl.num_entries
    rec["max_dup"] = tbl.max_dup

    for label in ("first", "second"):
        t0 = time.time()
        res = infer_pe_links(ids, seqs, reads, ksize, batch_size=16384,
                             table=tbl, logger=logger)
        rec[f"infer_{label}_s"] = round(time.time() - t0, 1)
        print(f"# infer {label}: {rec[f'infer_{label}_s']}s",
              file=sys.stderr)
    rec["links"] = int(res.node_mat.sum())

    print(json.dumps(rec))
    out = os.environ.get("HPP_OUT")
    if out:
        with open(out, "w") as f:
            json.dump(rec, f, indent=2)
    import shutil
    shutil.rmtree(workdir, ignore_errors=True)


if __name__ == "__main__":
    main()
