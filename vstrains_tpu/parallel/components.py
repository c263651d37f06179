"""Per-connected-component parallel disentanglement + extension.

metaSPAdes multi-sample graphs decompose into independent weakly-connected
components (BASELINE.json config 5); every decision in the
disentanglement/extension stages is component-local (branch splits, link
choices, coverage subtraction), so components are an embarrassingly
parallel axis — the closest analogue of expert parallelism in this
workload (SURVEY.md §2). The reference processes the whole graph
monolithically; component order only affects strain numbering.

Components are serialized to GFA text + plain dicts, so workers can be
local processes today and per-host dispatch over jax.distributed
tomorrow (the worker function is pure).

Global coverage medians (the delta thresholds) are computed over the whole
graph before splitting, matching the reference's global medians.
"""

from __future__ import annotations

import logging
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from typing import Dict, List, Set, Tuple

from vstrains_tpu.core.graph import GraphView

_LOG = logging.getLogger(__name__)


def weakly_connected_components(view: GraphView) -> List[List[str]]:
    """Node-id groups, ordered by first node appearance."""
    seen: Set[str] = set()
    comps: List[List[str]] = []
    for start_id, start in view.nodes.items():
        if start_id in seen:
            continue
        comp = []
        stack = [start]
        seen.add(start_id)
        while stack:
            v = stack.pop()
            comp.append(v.vid)
            for nb in v.all_neighbors():
                if nb.vid in view.nodes and nb.vid not in seen:
                    seen.add(nb.vid)
                    stack.append(nb)
        comps.append(sorted(comp, key=list(view.nodes).index))
    return comps


def component_payloads(view: GraphView, contig_dict: dict, pe_info: dict,
                       dcpy_pe_info: dict) -> List[dict]:
    """Split the graph + contigs + PE info into standalone per-component
    payloads (GFA text + plain dicts, process-portable)."""
    comps = weakly_connected_components(view)
    payloads = []
    for comp in comps:
        comp_set = set(comp)
        gfa_lines = []
        for vid in comp:
            v = view.nodes[vid]
            gfa_lines.append(f"S\t{vid}\t{v.seq}\tDP:f:{v.dp}")
        for (u, w), e in view.edges.items():
            if u in comp_set and w in comp_set:
                gfa_lines.append(f"L\t{u}\t+\t{w}\t+\t{e.overlap}M")
        sub_contigs = {cno: [list(c), ln, cov]
                       for cno, (c, ln, cov) in contig_dict.items()
                       if all(n in comp_set for n in c)}
        sub_pe = {k: c for k, c in pe_info.items()
                  if k[0] in comp_set and k[1] in comp_set}
        sub_dcpy = {k: c for k, c in dcpy_pe_info.items()
                    if k[0] in comp_set and k[1] in comp_set}
        payloads.append({
            "gfa_text": "\n".join(gfa_lines) + "\n",
            "contig_dict": sub_contigs,
            "pe_info": sub_pe,
            "dcpy_pe_info": sub_dcpy,
        })
    return payloads


def process_component(payload: dict, delta: float) -> Dict[str, list]:
    """Pure worker: disentangle + extend one component, return its strain
    dict. Runs the same stages 6-8 as the monolithic pipeline; the
    extension delta is computed component-locally (the monolithic path
    uses the global post-disentanglement median, SPAdes.py:237)."""
    import tempfile

    import numpy

    from vstrains_tpu.algos.branches import increment_nt_branch_coverage
    from vstrains_tpu.algos.decomposition import iter_graph_disentanglement
    from vstrains_tpu.algos.extension import best_matching, path_extension
    from vstrains_tpu.core.gfa import load_flipped_gfa
    from vstrains_tpu.ops.graph_ops import assign_edge_flow

    logger = logging.getLogger("component")
    with tempfile.NamedTemporaryFile("w", suffix=".gfa",
                                     delete=False) as tf:
        tf.write(payload["gfa_text"])
        gfa_path = tf.name
    try:
        view = load_flipped_gfa(gfa_path, logger)
    finally:
        os.unlink(gfa_path)
    from vstrains_tpu.core.pe_store import PEInfo

    assign_edge_flow(view)
    contig_dict = payload["contig_dict"]
    pe_info = PEInfo(payload["pe_info"])
    view = iter_graph_disentanglement(view, contig_dict, pe_info, delta,
                                      None, logger)
    full_link = best_matching(view, contig_dict, pe_info, logger)
    increment_nt_branch_coverage(view, logger)
    p_delta = 0.05 * float(numpy.median(
        [v.dp for v in view.graph.vertices()]))
    strain_dict, _usages, _view = path_extension(
        view, contig_dict, full_link, dict(payload["dcpy_pe_info"]),
        p_delta, None, logger)
    return strain_dict


def _allgather_json(obj, logger: logging.Logger = None):
    """All-gather one JSON-serializable object per jax.distributed
    process; returns the list of every process's object (self included),
    indexed by process id.

    Strain dicts are tiny host data, so they travel as length-padded
    uint8 buffers through two `process_allgather` calls (lengths, then
    payload bytes) — the cross-host control-plane analogue of the int32-halves
    matrix merge in parallel/distributed.py."""
    import json

    import numpy as np

    import jax
    import jax.numpy as jnp
    from jax.experimental.multihost_utils import process_allgather

    def _np_default(o):
        if isinstance(o, np.integer):
            return int(o)
        if isinstance(o, np.floating):
            return float(o)
        raise TypeError(f"not JSON-serializable: {type(o)!r}")

    raw = json.dumps(obj, default=_np_default).encode()
    lens = np.atleast_1d(np.asarray(
        process_allgather(jnp.asarray(np.int32(len(raw))))))
    cap = int(lens.max())
    buf = np.zeros(cap, np.uint8)
    buf[: len(raw)] = np.frombuffer(raw, np.uint8)
    bufs = np.asarray(process_allgather(jnp.asarray(buf)))
    if jax.process_count() == 1:
        bufs = bufs.reshape(1, -1)
    return [json.loads(bytes(bufs[i][: int(lens[i])]).decode())
            for i in range(len(lens))]


def run_components_multihost(view: GraphView, contig_dict: dict,
                             pe_info: dict, dcpy_pe_info: dict,
                             delta: float,
                             logger: logging.Logger = None
                             ) -> Dict[str, list]:
    """Per-component extraction sharded round-robin over jax.distributed
    processes — the cross-host dispatch of the same worker payloads the
    local process pool runs (docstring at module top).

    Every process holds the replicated graph and PE info (they are small
    — viral genomes), extracts the components with index % nproc ==
    process_index, and the per-component strain dicts are exchanged with
    `_allgather_json`, so all processes return the identical merged
    result in deterministic component order."""
    import jax

    logger = logger or _LOG
    rank, nproc = jax.process_index(), jax.process_count()
    payloads = component_payloads(view, contig_dict, pe_info, dcpy_pe_info)
    mine = {ci: process_component(payloads[ci], delta)
            for ci in range(rank, len(payloads), nproc)}
    logger.info("per-component multihost: process %d/%d extracted %d of "
                "%d components", rank, nproc, len(mine), len(payloads))
    results: Dict[int, dict] = {}
    for per_proc in _allgather_json(mine, logger):
        results.update({int(ci): sd for ci, sd in per_proc.items()})
    merged: Dict[str, list] = {}
    for ci in range(len(payloads)):
        for sno, rec in results.get(ci, {}).items():
            name = sno if len(payloads) == 1 else f"{sno}c{ci}"
            merged[name] = rec
    return merged


def _host_only_worker() -> None:
    """Worker-process initializer: pin this process's JAX to the CPU
    backend before anything can initialize a backend. Workers run host
    graph algorithms (assign_edge_flow's device branch included), and the
    parent process owns the accelerator: a JAX process that opens a GPU
    reserves most of its memory, so a worker that touched the card would
    fail for want of memory, or starve the parent."""
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    jax.config.update("jax_platforms", "cpu")


def host_worker_pool(workers: int) -> ProcessPoolExecutor:
    """Process pool for host-side component work, kept off the device
    (_host_only_worker). Spawned, not forked: fork is unsafe in a
    process with live JAX runtime threads."""
    return ProcessPoolExecutor(
        max_workers=workers,
        mp_context=multiprocessing.get_context("spawn"),
        initializer=_host_only_worker)


def run_components(view: GraphView, contig_dict: dict, pe_info: dict,
                   dcpy_pe_info: dict, delta: float,
                   workers: int = 1,
                   logger: logging.Logger = None) -> Dict[str, list]:
    """Disentangle+extend every component (optionally in parallel worker
    processes) and merge strains with component-suffixed ids."""
    logger = logger or _LOG
    payloads = component_payloads(view, contig_dict, pe_info, dcpy_pe_info)
    logger.info("per-component extraction: %d components, %d workers",
                len(payloads), workers)
    if workers > 1 and len(payloads) > 1:
        with host_worker_pool(workers) as ex:
            results = list(ex.map(process_component, payloads,
                                  [delta] * len(payloads)))
    else:
        results = [process_component(p, delta) for p in payloads]
    merged: Dict[str, list] = {}
    for ci, strain_dict in enumerate(results):
        for sno, rec in strain_dict.items():
            name = sno if len(results) == 1 else f"{sno}c{ci}"
            merged[name] = rec
    return merged
