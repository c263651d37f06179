"""vstrains-tpu-prewarm: populate the executable cache ahead of a run.

Device kernel compiles cost seconds per shape, and the compiled
signature depends only on (batch size, read-width bucket, k-mer-table
bucket shapes, node count), never on read content. This tool replays the pipeline's cheap
host stages (parse -> canonize -> threshold -> simplification; the
same code path as pipeline.run stages 1-3) to recover the EXACT table
the PE stage will build, derives the width buckets the real read
library will produce, and compiles every (width x batch) kernel
concurrently into the persistent compilation cache (utils/jaxcache.py:
JAX_COMPILATION_CACHE_DIR when set, else a fixed directory in the
checkout).

After a prewarm, the real run's PE stage starts warm: its first
dispatch loads serialized executables instead of compiling. Usage:

    vstrains-tpu-prewarm -g graph.gfa -p contigs.paths \
        -fwd fwd.fastq -rve rve.fastq [--pe-batch-size 16384]
"""

from __future__ import annotations

import argparse
import gzip
import logging
import os
import sys
import tempfile
import threading
import time
from typing import List

import numpy as np

_LOG = logging.getLogger("vstrains_tpu.prewarm")


def _sample_read_widths(path: str, limit: int = 200_000) -> np.ndarray:
    """Lengths of the first `limit` reads (plain or gzip FASTQ)."""
    opener = gzip.open if path.endswith(".gz") else open
    lens: List[int] = []
    with opener(path, "rt") as fh:
        for i, line in enumerate(fh):
            if i % 4 == 1:
                lens.append(len(line.strip()))
                if len(lens) >= limit:
                    break
    return np.asarray(lens, np.int32)


def plan_widths(fwd: str, rve: str, split_len: int, batch_size: int,
                est_pairs: int, multiple: int = 32,
                min_frac: float = 0.10) -> List[int]:
    """Predict the width buckets ops.pe_infer._length_buckets will form
    (same rounding/merge rules, computed on a head sample of the
    library). Over-predicting only wastes a background compile; the
    real run compiles anything missed."""
    wf = _sample_read_widths(fwd)
    wr = _sample_read_widths(rve)
    n = min(len(wf), len(wr))
    if n == 0:
        return []
    w = np.maximum(wf[:n], wr[:n])
    w = np.maximum(w, split_len)
    t_max = int(-(-int(w.max()) // multiple) * multiple)
    w = np.minimum(-(-w // multiple) * multiple, t_max)
    widths, counts = np.unique(w, return_counts=True)
    if len(widths) == 1 or est_pairs < 4 * batch_size:
        return [t_max]
    kept = [int(wd) for wd, c in zip(widths, counts)
            if c >= min_frac * n or wd == widths[-1]]
    return sorted(set(kept), reverse=True)


def prewarm(args, logger: logging.Logger = None) -> dict:
    logger = logger or _LOG
    from vstrains_tpu.algos.preprocess import (graph_simplification,
                                               reindexing)
    from vstrains_tpu.core.canon import load_gfa_canonized
    from vstrains_tpu.core.contig_io import spades_paths_parser
    from vstrains_tpu.core.fastq import ReadPairBatch
    from vstrains_tpu.ops.graph_ops import threshold_estimation
    from vstrains_tpu.ops.pe_infer import infer_pe_links

    from vstrains_tpu.utils.jaxcache import enable_persistent_cache
    cache_dir = enable_persistent_cache(logger)
    import jax
    backend = jax.default_backend()
    t_start = time.time()

    # stages 1-3 (host-cheap), mirroring pipeline.run exactly so the
    # simplified node set — hence the k-mer table shapes — matches
    view = load_gfa_canonized(args.gfa_file, logger)
    view0 = view.compact()
    view0, idx_mapping = reindexing(view0)
    if getattr(args, "min_cov", None) is not None:
        threshold = args.min_cov
    else:
        dps = [v.dp for v in view0.graph.vertices()]
        threshold = threshold_estimation(np.array(dps), logger)
    contig_dict, _ = spades_paths_parser(
        view0, idx_mapping, args.path_file,
        getattr(args, "min_len", 250) or 250, threshold, logger)
    graph_simplification(view0, None, threshold, logger)
    view1 = view0.compact()
    ids = list(view1.nodes.keys())
    seqs = [view1.nodes[i].seq for i in ids]
    ksize = (next(iter(view1.edges.values())).overlap
             if view1.num_edges() > 0 else 0)
    if ksize <= 0:
        raise RuntimeError("graph has no edges; nothing to prewarm")

    bsz = getattr(args, "pe_batch_size", 16384) or 16384
    fsize = os.path.getsize(args.fwd)
    if args.fwd.endswith(".gz"):
        fsize *= 4
    est_pairs = fsize // 540  # ~bytes per 250bp record; order-of-magnitude
    widths = plan_widths(args.fwd, args.rve, ksize + 1, bsz, est_pairs)
    logger.info("prewarm: N=%d nodes, k=%d, batch=%d, widths=%s, "
                "backend=%s", len(ids), ksize, bsz, widths, backend)

    quiet = logging.getLogger("vstrains_tpu.prewarm.worker")
    quiet.setLevel(logging.WARNING)
    errs: List[str] = []

    def _warm(width: int) -> None:
        try:
            zc = np.zeros((bsz, width), np.uint8)
            zl = np.zeros(bsz, np.int32)
            warm_batch = ReadPairBatch(zc, zl, zc, zl, 0, 0, bsz)
            t0 = time.time()
            infer_pe_links(ids, seqs, warm_batch, ksize, batch_size=bsz,
                           logger=quiet)
            logger.info("prewarm width %d: %.1fs", width,
                        time.time() - t0)
        except Exception as exc:  # noqa: BLE001 — report, don't abort
            errs.append(f"width {width}: {exc}")

    threads = [threading.Thread(target=_warm, args=(w,), daemon=True)
               for w in widths]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for e in errs:
        logger.warning("prewarm failure: %s", e)

    n_cached = (len(os.listdir(cache_dir))
                if cache_dir and os.path.isdir(cache_dir) else -1)
    out = {"backend": backend, "nodes": len(ids), "k": ksize,
           "batch": bsz, "widths": widths,
           "wall_seconds": round(time.time() - t_start, 1),
           "cache_entries": n_cached, "errors": errs}
    logger.info("prewarm done in %.1fs (%s cache entries)",
                out["wall_seconds"], n_cached)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="vstrains-tpu-prewarm",
        description="Compile the PE-inference kernels for a dataset "
                    "into the persistent executable cache before the "
                    "real run.")
    ap.add_argument("-g", "--gfa", dest="gfa_file", required=True)
    ap.add_argument("-p", "--paths", dest="path_file", required=True)
    ap.add_argument("-fwd", dest="fwd", required=True)
    ap.add_argument("-rve", dest="rve", required=True)
    ap.add_argument("-mc", "--minimum-coverage", dest="min_cov",
                    type=float, default=None)
    ap.add_argument("-ml", "--minimum-contig-length", dest="min_len",
                    type=int, default=250)
    ap.add_argument("--pe-batch-size", dest="pe_batch_size", type=int,
                    default=16384)
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    rec = prewarm(args)
    return 1 if rec["errors"] else 0


if __name__ == "__main__":
    sys.exit(main())
