"""End-to-end pipeline orchestrator with stage checkpoints and resume.

Stage structure parity with /root/reference/utils/VStrains_SPAdes.py:25-280:
  1. parse graph + canonize + reindex        (gfa/graph_L0.gfa, graph_L0r.gfa)
  2. coverage threshold + contig parse       [ckpt: contigs]
  3. low-coverage simplification             (gfa/s_graph_L1.gfa)
  4. PE-link inference                       (aln/pe_info, aln/st_info)
     — in-process on-device engine (ops/pe_infer) instead of the
       reference's child Python process (SPAdes.py:119-132); the files are
       still written as stage checkpoints with identical format.
                                             [ckpt: pe_links]
  5. edge cleaning                           (gfa/es_graph_L2.gfa)
                                             [ckpt: cleaned]
  6. iterative disentanglement               (gfa/split_graph_*.gfa)
                                             [ckpt: disentangled]
  7. best matching + NT coverage inflation   (gfa/split_graph_final.gfa)
  8. contig path extension                   (gfa/graph_S*.gfa)
                                             [ckpt: extended]
  9. finalize: trim/dedup/repeat-resolution  (strain.fasta, strain.paths)

The reference's pipeline is only implicitly resumable (stage GFA files on
disk, manual restart). Here `args.resume` restarts from the most advanced
completed checkpoint: graphs reload from their stage GFAs, host state
(contig/PE dicts, mappings) from ckpt/<stage>.json (utils/checkpoint.py).
Per-stage wall times land in <out>/timings.json (utils/tracing.py).
"""

from __future__ import annotations

import logging
import os
import time

import numpy

from vstrains_tpu.algos.branches import increment_nt_branch_coverage
from vstrains_tpu.algos.contig_ops import (contig_dup_removed_s,
                                           contig_resolve,
                                           strain_repeat_resol,
                                           trim_contig_dict)
from vstrains_tpu.algos.decomposition import (edge_cleaning,
                                              iter_graph_disentanglement)
from vstrains_tpu.algos.extension import best_matching, path_extension
from vstrains_tpu.algos.preprocess import graph_simplification, reindexing
from vstrains_tpu.core.canon import load_gfa_canonized
from vstrains_tpu.core.contig_io import (contig_dict_to_fasta,
                                         contig_dict_to_path,
                                         spades_paths_parser)
from vstrains_tpu.core.fastq import load_read_pairs
from vstrains_tpu.core.gfa import (load_flipped_gfa, store_reinit_graph,
                                   write_gfa)
from vstrains_tpu.ops.graph_ops import assign_edge_flow, threshold_estimation
from vstrains_tpu.core.pe_store import PEInfo
from vstrains_tpu.ops.pe_infer import (infer_pe_links,
                                       pe_info_sparse_from_result,
                                       write_pe_files)
from vstrains_tpu.utils import checkpoint as ckpt
from vstrains_tpu.utils.tracing import StageTimer

_LOG = logging.getLogger(__name__)

_STAGE_ORDER = {s: i for i, s in enumerate(ckpt.STAGES)}


class PipelineError(Exception):
    pass


def _prefetch_pe_compile(ids, seqs, ksize, batch_size, fwd_path, logger,
                         table_thread=None, table_box=None):
    """Best-effort background warm-up of the PE kernel compile.

    The fused batch kernel's compiled signature depends only on (batch,
    read-width, table shapes), never on read content, so a fabricated
    zero-read batch of the right width triggers the exact compile on the
    device while the real FASTQs load in the main thread; the real
    dispatch then waits on jit's compile lock instead of starting from
    scratch. Any failure here is swallowed — it only costs the
    overlap."""
    try:
        import gzip

        import numpy as _np

        from vstrains_tpu.core.fastq import ReadPairBatch

        opener = gzip.open if fwd_path.endswith(".gz") else open
        width = 0
        with opener(fwd_path, "rt") as fh:
            for i, line in enumerate(fh):
                if i % 4 == 1:
                    width = max(width, len(line.strip()))
                if i >= 4095:
                    break
        if width < ksize + 1:
            return
        # infer_pe_links clamps the batch of a library smaller than one
        # batch; mirror that from a size estimate (~bytes per FASTQ
        # record; gzip compresses FASTQ ~4x) so the warm shape matches
        fsize = os.path.getsize(fwd_path)
        if fwd_path.endswith(".gz"):
            fsize *= 4
        est_pairs = fsize // max(2 * width + 40, 1)
        B = 512
        while B < min(est_pairs, batch_size):
            B *= 2
        B = min(B, batch_size)
        T = -(-width // 32) * 32
        zc = _np.zeros((B, T), _np.uint8)
        zl = _np.zeros(B, _np.int32)
        warm = ReadPairBatch(zc, zl, zc, zl, 0, 0, B)
        quiet = logging.getLogger("vstrains_tpu.pe_prefetch")
        quiet.setLevel(logging.WARNING)
        table = None
        if table_thread is not None:
            # reuse the pipeline's background table build instead of
            # constructing a duplicate
            table_thread.join()
            table = (table_box or {}).get("table")
        infer_pe_links(ids, seqs, warm, ksize, batch_size=batch_size,
                       table=table, logger=quiet)
        logger.debug("PE kernel compile prefetched (width %d)", width)
    except Exception as exc:  # never fail the pipeline from here
        logger.debug("PE compile prefetch skipped: %s", exc)


def _enable_compilation_cache(logger) -> None:
    """Persistent XLA compilation cache: kernel compiles amortize across
    runs (utils/jaxcache.py)."""
    from vstrains_tpu.utils.jaxcache import enable_persistent_cache

    cache_dir = enable_persistent_cache(logger)
    if cache_dir:
        logger.info("compilation cache: %s", cache_dir)


def run(args, logger: logging.Logger = None) -> int:
    """args needs: gfa_file, path_file, fwd, rve, output_dir, min_cov,
    min_len, dev (mirrors the reference CLI namespace); optional: resume,
    pe_batch_size, profile_dir."""
    logger = logger or _LOG
    _enable_compilation_cache(logger)
    temp_dir = args.output_dir
    timer = StageTimer(profile_dir=getattr(args, "profile_dir", None))
    logger.info("vstrains-tpu pipeline started")
    t0 = time.time()

    resume_from = None
    if getattr(args, "resume", False):
        resume_from = ckpt.latest_stage(temp_dir)
        logger.info("resume requested; latest checkpoint: %s", resume_from)

    def done(stage: str) -> bool:
        return (resume_from is not None
                and _STAGE_ORDER[stage] <= _STAGE_ORDER[resume_from])

    dev = getattr(args, "dev", False)

    def check(view_, where):
        if dev:
            from vstrains_tpu.utils.validate import validate_view
            validate_view(view_, where)

    # ---- stage 1: parse + canonize (cheap; recomputed unless resuming) ----
    if resume_from is None:
        logger.info("[stage] parse graph + contig paths")
        with timer.stage("parse+canonize", logger):
            view = load_gfa_canonized(args.gfa_file, logger)
            write_gfa(view, f"{temp_dir}/gfa/graph_L0.gfa", logger)
            view0 = view.compact()
            view0, idx_mapping = reindexing(view0)
            write_gfa(view0, f"{temp_dir}/gfa/graph_L0r.gfa", logger)
    else:
        view0 = load_flipped_gfa(f"{temp_dir}/gfa/graph_L0r.gfa", logger)
        idx_mapping = None  # restored from the contigs checkpoint below

    # ---- stage 2: threshold + contigs ----
    if done("contigs"):
        st = ckpt.load_stage(temp_dir, "contigs")
        threshold = st["threshold"]
        idx_mapping = st["idx_mapping"]
        contig_dict = st["contig_dict"]
        contig_info = st["contig_info"]
        copy_contig_dict = st["copy_contig_dict"]
        logger.info("resumed stage contigs (threshold=%s)", threshold)
    else:
        with timer.stage("threshold+contigs", logger):
            if getattr(args, "min_cov", None) is not None:
                threshold = args.min_cov
                logger.info("user-defined node minimum coverage: %s",
                            threshold)
            else:
                dps = [v.dp for v in view0.graph.vertices()]
                threshold = threshold_estimation(numpy.array(dps), logger)
                logger.info("computed node minimum coverage: %s", threshold)
                if dev:
                    from vstrains_tpu.ops.graph_ops import save_coverage_plot
                    save_coverage_plot(numpy.array(dps), threshold,
                                       f"{temp_dir}/tmp/depth_hist.png")

            contig_dict, contig_info = spades_paths_parser(
                view0, idx_mapping, args.path_file,
                getattr(args, "min_len", 250) or 250, threshold, logger)
            copy_contig_dict = {
                cno: [list(contig), clen, ccov]
                for cno, [contig, clen, ccov] in contig_dict.items()}
            contig_dict_to_path(contig_dict,
                                f"{temp_dir}/tmp/init_contigs.paths")
            contig_dict_to_fasta(view0, contig_dict,
                                 f"{temp_dir}/tmp/init_contigs.fasta")
            if getattr(args, "ref_file", None):
                from vstrains_tpu.evals.refmap import map_ref_to_contig
                map_ref_to_contig(contig_dict, view0, args.ref_file,
                                  logger)
            ckpt.save_stage(temp_dir, "contigs", {
                "threshold": threshold, "idx_mapping": idx_mapping,
                "contig_dict": contig_dict, "contig_info": contig_info,
                "copy_contig_dict": copy_contig_dict})

    # ---- stage 3: preprocess ----
    if done("pe_links"):
        view1 = load_flipped_gfa(f"{temp_dir}/gfa/s_graph_L1.gfa", logger)
    else:
        logger.info("[stage] preprocessing")
        with timer.stage("simplification", logger):
            graph_simplification(view0, None, threshold, logger)
            if getattr(args, "tip_removal", False):
                from vstrains_tpu.algos.tips import tip_removal_s
                tip_removal_s(view0, contig_dict, logger)
            write_gfa(view0, f"{temp_dir}/gfa/s_graph_L1.gfa", logger)
            view1 = view0.compact()
            check(view1, "post-simplification")

    # drop contigs that touch removed nodes
    for cno, [contig, _, _] in list(contig_dict.items()):
        if any(c not in view1.nodes for c in contig):
            contig_dict.pop(cno)
            logger.debug("dropping contig %s: it crosses a removed node", cno)

    # graph k-mer size = overlap of the first edge
    ksize = (next(iter(view1.edges.values())).overlap
             if view1.num_edges() > 0 else 0)
    logger.info("graph kmer size: %s", ksize)
    if ksize <= 0:
        raise PipelineError("invalid kmer-size, the graph does not contain "
                            "any edges")

    # ---- stage 4: PE-link inference (on-device) ----
    if done("pe_links"):
        st = ckpt.load_stage(temp_dir, "pe_links")
        pe_info = PEInfo(st["pe_info"])
        dcpy_pe_info = PEInfo(st["dcpy_pe_info"])
        logger.info("resumed stage pe_links (%d pairs)", len(pe_info))
    else:
        logger.info("[stage] PE link inference")
        with timer.stage("pe_inference", logger):
            ids = list(view1.nodes.keys())
            seqs = [view1.nodes[i].seq for i in ids]
            import threading
            bsz = getattr(args, "pe_batch_size", 16384)
            # the k-mer table build (seconds of host time at metaSPAdes
            # scale) overlaps FASTQ loading on a background thread; the
            # compile-prefetch thread reuses the same table
            from vstrains_tpu.ops.pe_infer import build_table_auto
            table_box = {}

            def _build_table():
                try:
                    table_box["table"] = build_table_auto(
                        seqs, ksize + 1, logger)
                except Exception as exc:  # main thread rebuilds
                    logger.warning("background table build failed: %s",
                                   exc)

            table_thread = threading.Thread(target=_build_table,
                                            daemon=True)
            table_thread.start()
            threading.Thread(
                target=_prefetch_pe_compile,
                args=(ids, seqs, ksize, bsz, args.fwd, logger),
                kwargs=dict(table_thread=table_thread,
                            table_box=table_box),
                daemon=True).start()
            reads = load_read_pairs(args.fwd, args.rve, ksize + 1,
                                    pad_to_multiple=32)
            logger.info("reads: used=%d, with_N=%d, short=%d",
                        reads.used_reads, reads.n_reads, reads.short_reads)
            table_thread.join()
            pe_result = infer_pe_links(
                ids, seqs, reads, ksize,
                batch_size=getattr(args, "pe_batch_size", 16384),
                table=table_box.get("table"),
                logger=logger)
            # aln file format: the reference's N^2-line files degenerate
            # to their nonzero lines on load (docs/DIVERGENCES.md #17),
            # so 'auto' switches to the sparse writer above 5,000 nodes
            # instead of emitting hundreds-of-GB of zeros
            pe_files = getattr(args, "pe_files", "auto")
            if pe_files == "auto":
                pe_files = "full" if len(ids) <= 5000 else "sparse"
            if pe_files == "full":
                write_pe_files(pe_result, f"{temp_dir}/aln/pe_info",
                               f"{temp_dir}/aln/st_info")
                logger.info("PE link matrices written (full format)")
            elif pe_files == "sparse":
                from vstrains_tpu.ops.pe_infer import write_pe_files_sparse
                write_pe_files_sparse(pe_result, f"{temp_dir}/aln/pe_info",
                                      f"{temp_dir}/aln/st_info")
                logger.info("PE link matrices written (sparse format, "
                            "N=%d nodes)", len(ids))
            else:
                logger.info("aln/pe_info skipped (--pe-files off)")
            pe_info, dcpy_pe_info = pe_info_sparse_from_result(
                view1.nodes.keys(), pe_result)
            ckpt.save_stage(temp_dir, "pe_links", {
                "pe_info": pe_info, "dcpy_pe_info": dcpy_pe_info})

    # ---- stage 5: edge cleaning ----
    if done("cleaned"):
        st = ckpt.load_stage(temp_dir, "cleaned")
        contig_dict = st["contig_dict"]
        pe_info = PEInfo(st["pe_info"])
        view2 = load_flipped_gfa(f"{temp_dir}/gfa/es_graph_L2.gfa", logger)
        assign_edge_flow(view2)
    else:
        with timer.stage("edge_cleaning", logger):
            edge_cleaning(view1, contig_dict, pe_info, logger)
            view2 = store_reinit_graph(
                view1, f"{temp_dir}/gfa/es_graph_L2.gfa", logger)
            check(view2, "post-edge-cleaning")
            contig_dict_to_path(contig_dict,
                                f"{temp_dir}/tmp/pre_contigs.paths")
            contig_dict_to_fasta(view2, contig_dict,
                                 f"{temp_dir}/tmp/pre_contigs.fasta")
            if getattr(args, "ref_file", None):
                from vstrains_tpu.evals.refmap import (map_ref_to_contig,
                                                       map_ref_to_graph)
                map_ref_to_graph(args.ref_file, view2, logger)
                map_ref_to_contig(contig_dict, view2, args.ref_file,
                                  logger)
            ckpt.save_stage(temp_dir, "cleaned", {
                "contig_dict": contig_dict, "pe_info": pe_info})

    # ---- per-component fast path (metaSPAdes multi-component graphs) ----
    mono = True
    if getattr(args, "per_component", False) and not done("extended"):
        from vstrains_tpu.parallel.components import (
            run_components, weakly_connected_components)
        n_comp = len(weakly_connected_components(view2))
        if n_comp > 1:
            mono = False
            logger.info("[stage] per-component disentanglement + "
                        "extension (%d components)", n_comp)
            with timer.stage("per_component_extraction", logger):
                delta = 0.05 * float(numpy.median(
                    [v.dp for v in view2.graph.vertices()]))
                import jax
                if jax.process_count() > 1:
                    from vstrains_tpu.parallel.components import (
                        run_components_multihost)
                    strain_dict = run_components_multihost(
                        view2, contig_dict, pe_info, dcpy_pe_info,
                        delta, logger=logger)
                else:
                    strain_dict = run_components(
                        view2, contig_dict, pe_info, dcpy_pe_info, delta,
                        workers=getattr(args, "component_workers", 1) or 1,
                        logger=logger)
                ckpt.save_stage(temp_dir, "extended",
                                {"strain_dict": strain_dict})

    # ---- stage 6: disentanglement ----
    if not mono:
        pass
    elif done("disentangled"):
        st = ckpt.load_stage(temp_dir, "disentangled")
        contig_dict = st["contig_dict"]
        pe_info = PEInfo(st["pe_info"])
        viewf = load_flipped_gfa(f"{temp_dir}/gfa/ckpt_disentangled.gfa",
                                 logger)
        assign_edge_flow(viewf)
    else:
        logger.info("[stage] graph disentanglement")
        with timer.stage("disentanglement", logger):
            delta = 0.05 * float(numpy.median(
                [v.dp for v in view2.graph.vertices()]))
            scorer = None
            if getattr(args, "ref_file", None) and getattr(args, "dev",
                                                           False):
                from vstrains_tpu.evals.refmap import SplitScorer
                scorer = SplitScorer(args.ref_file,
                                     out_dir=f"{temp_dir}/tmp",
                                     logger=logger)
            viewf = iter_graph_disentanglement(view2, contig_dict, pe_info,
                                               delta, temp_dir, logger,
                                               scorer=scorer)
            if scorer is not None:
                logger.info("split decisions vs reference: %s",
                            scorer.counts)
            check(viewf, "post-disentanglement")
            contig_dict_to_path(contig_dict,
                                f"{temp_dir}/tmp/post_contigs.paths")
            contig_dict_to_fasta(viewf, contig_dict,
                                 f"{temp_dir}/tmp/post_contigs.fasta")
            if getattr(args, "ref_file", None):
                from vstrains_tpu.evals.refmap import (map_ref_to_contig,
                                                       map_ref_to_graph)
                map_ref_to_graph(args.ref_file, viewf, logger)
                map_ref_to_contig(contig_dict, viewf, args.ref_file,
                                  logger)
            write_gfa(viewf, f"{temp_dir}/gfa/ckpt_disentangled.gfa")
            ckpt.save_stage(temp_dir, "disentangled", {
                "contig_dict": contig_dict, "pe_info": pe_info})

    # ---- stage 7+8: link refinement + extension ----
    if not mono:
        pass  # strain_dict already produced per component
    elif done("extended"):
        st = ckpt.load_stage(temp_dir, "extended")
        strain_dict = st["strain_dict"]
    else:
        logger.info("[stage] contig path extension")
        with timer.stage("extension", logger):
            full_link = best_matching(viewf, contig_dict, pe_info, logger)
            increment_nt_branch_coverage(viewf, logger)
            write_gfa(viewf, f"{temp_dir}/gfa/split_graph_final.gfa",
                      logger)
            p_delta = 0.05 * float(numpy.median(
                [v.dp for v in viewf.graph.vertices()]))
            strain_dict, usages, viewf = path_extension(
                viewf, contig_dict, full_link, dcpy_pe_info, p_delta,
                temp_dir, logger)
            ckpt.save_stage(temp_dir, "extended",
                            {"strain_dict": strain_dict})

    # ---- stage 9: finalize ----
    logger.info("[stage] finalization")
    with timer.stage("finalize", logger):
        contig_resolve(strain_dict)
        viewl = load_flipped_gfa(f"{temp_dir}/gfa/es_graph_L2.gfa", logger)
        trim_contig_dict(viewl, strain_dict, logger)
        contig_dup_removed_s(strain_dict, logger)
        contig_dict_to_path(strain_dict,
                            f"{temp_dir}/tmp/tmp_strain.paths", None, False)
        strain_repeat_resol(view0, strain_dict, contig_info,
                            copy_contig_dict, logger)

        logger.info("[stage] write results")
        contig_dict_to_fasta(view0, strain_dict,
                             f"{temp_dir}/strain.fasta")
        contig_dict_to_path(strain_dict, f"{temp_dir}/strain.paths",
                            idx_mapping, True)
        if getattr(args, "ref_file", None):
            from vstrains_tpu.evals.refmap import strain_accuracy
            strain_accuracy(strain_dict, view0, args.ref_file, logger)
    timer.dump(f"{temp_dir}/timings.json")
    logger.info("vstrains-tpu finished in %.2fs", time.time() - t0)
    return 0
