"""Reference-guided debug evaluation (dev mode, component C26).

The reference shells out to minimap2 at every stage to label nodes /
contigs / strains against known strain references
(/root/reference/utils/VStrains_Utilities.py:34-144,
VStrains_Decomposition.py:1045-1071). Its node-level criterion is
`nm == 0 and match_region == seg_len` — i.e. the node is an *exact
substring* of the strain — so the device-side replacement needs no aligner:

  * node -> strain: exact substring containment (either strand), seeded by
    the PE engine's k-mer hashes and verified by direct comparison;
  * contig/strain -> reference: k-mer containment score with the
    reference's 0.999 acceptance (proxy for nmatch/nblock >= 0.999).

These power the same de-facto integration-test role the reference's dev
mode plays (SURVEY.md section 4).
"""

from __future__ import annotations

import logging
from typing import Dict, List, Sequence, Tuple

from vstrains_tpu.algos.tips import kmer_containment
from vstrains_tpu.core.graph import GraphView
from vstrains_tpu.core.seq import revcomp_str

_LOG = logging.getLogger(__name__)


def load_fasta(path: str) -> Dict[str, str]:
    seqs: Dict[str, str] = {}
    name = None
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line.startswith(">"):
                name = line[1:].split(" ")[0]
                seqs[name] = ""
            elif line and name is not None:
                seqs[name] += line
    return seqs


def map_ref_to_graph(ref_file: str, view: GraphView,
                     logger: logging.Logger = None
                     ) -> Dict[str, List[str]]:
    """strain -> [node ids whose sequence matches the strain exactly]
    (parity: Utilities:34-90, nm==0 full-length criterion)."""
    logger = logger or _LOG
    refs = load_fasta(ref_file)
    strain_dict: Dict[str, List[str]] = {}
    for no, node in view.nodes.items():
        seq = node.seq
        rc = revcomp_str(seq)
        for ref_no, ref_seq in refs.items():
            if seq in ref_seq or rc in ref_seq:
                strain_dict.setdefault(ref_no, []).append(no)
    logger.debug("strain-to-node map")
    for ref_no, nodes in strain_dict.items():
        logger.debug("strains: %s Path: %s", ref_no, nodes)
    return strain_dict


def map_ref_to_contig(contig_dict: dict, view: GraphView, ref_file: str,
                      logger: logging.Logger = None,
                      accept: float = 0.999) -> Dict[str, set]:
    """strain -> {contig ids with >= 99.9%% k-mer containment}
    (parity: Utilities:93-136)."""
    logger = logger or _LOG
    from vstrains_tpu.algos.pathmath import path_ids_to_seq
    refs = load_fasta(ref_file)
    strain_dict: Dict[str, set] = {}
    for cno, (contig, _, _) in contig_dict.items():
        try:
            seq = path_ids_to_seq(view, contig)
        except KeyError:
            continue
        for ref_no, ref_seq in refs.items():
            if kmer_containment(seq, ref_seq) >= accept:
                strain_dict.setdefault(ref_no, set()).add(cno)
    for sno, cnos in strain_dict.items():
        logger.debug("strain %s matched by %d contigs: %s",
                     sno, len(cnos), sorted(cnos))
    return strain_dict


def strain_accuracy(strain_dict: dict, view: GraphView, ref_file: str,
                    logger: logging.Logger = None
                    ) -> List[Tuple[str, str, float]]:
    """Score each reconstructed strain against its best reference."""
    logger = logger or _LOG
    from vstrains_tpu.algos.pathmath import path_ids_to_seq
    refs = load_fasta(ref_file)
    out = []
    for sno, (contig, _, _) in strain_dict.items():
        try:
            seq = path_ids_to_seq(view, contig)
        except KeyError:
            continue
        best_ref, best = None, -1.0
        for ref_no, ref_seq in refs.items():
            s = kmer_containment(seq, ref_seq)
            if s > best:
                best_ref, best = ref_no, s
        out.append((sno, best_ref, best))
        logger.info("strain %s -> %s (containment %.4f)", sno, best_ref,
                    best)
    return out


class SplitScorer:
    """Per-decision Correct / False-Positive / Error labeling of balance
    splits against known strain references, plus the flow-vs-PE scatter
    artifact (parity: /root/reference/utils/VStrains_Decomposition.py:
    209-251, 362-416, 509-529).

    The reference's minimap2 perfect-alignment criterion (nm==0, full
    length) becomes exact substring containment — graph node sequences
    are error-free segments, so the two agree; its near-match criterion
    (nm<5) becomes k-mer containment >= 0.95.

      Correct:        the kept link's endpoints share a perfect strain.
      False-Positive: no shared strain, but an endpoint matches no strain
                      perfectly (graph-error node) or the pair's near
                      strains include one present on only one side of the
                      branch — the graph, not the splitter, is wrong.
      Error:          a genuinely wrong link.
    """

    CUT = 100  # scatter only low-PE decisions (reference cut at :116)

    def __init__(self, ref_file: str, out_dir: str = None,
                 logger: logging.Logger = None):
        self.refs = load_fasta(ref_file)
        self.out_dir = out_dir
        self.logger = logger or _LOG
        self.counts = {"correct": 0, "false_positive": 0, "error": 0}
        self._plot_id = 0
        self._reset_points()
        self._perfect_cache: Dict[str, set] = {}
        self._near_cache: Dict[str, set] = {}

    def _reset_points(self):
        self._pts = {"correct": [], "false_positive": [], "error": []}
        self._err_text: List[str] = []

    def _perfect(self, vid: str, seq: str) -> set:
        if vid not in self._perfect_cache:
            rc = revcomp_str(seq)
            self._perfect_cache[vid] = {
                r for r, s in self.refs.items() if seq in s or rc in s}
        return self._perfect_cache[vid]

    def _near(self, vid: str, seq: str) -> set:
        if vid not in self._near_cache:
            self._near_cache[vid] = {
                r for r, s in self.refs.items()
                if kmer_containment(seq, s) >= 0.95}
        return self._near_cache[vid]

    def score_branch(self, view: GraphView, no: str, us: Sequence[str],
                     ws: Sequence[str], accepted_links: dict) -> None:
        """Label every kept link of one branch split. Call before the
        branch node is removed (endpoint sequences must still exist)."""
        log = self.logger
        perf = {vid: self._perfect(vid, view.nodes[vid].seq)
                for vid in set(us) | set(ws)}
        lrefs = set().union(*(perf[u] for u in us)) if us else set()
        rrefs = set().union(*(perf[w] for w in ws)) if ws else set()
        sym_diff = lrefs.symmetric_difference(rrefs)
        error_nos = {vid for vid in set(us) | set(ws) if not perf[vid]}
        expect = {(u, w) for u in us for w in ws if perf[u] & perf[w]}
        if sym_diff:
            log.debug("branch %s: strains %s appear on only one side "
                      "(graph mismatch)", no, sorted(sym_diff))
        if set(accepted_links) == expect:
            log.debug("branch %s: split matches the reference "
                      "expectation", no)
        else:
            log.debug("branch %s: split diverges from reference "
                      "expectation %s", no, sorted(expect))
        for (uid, wid), (sub_flow, pe) in accepted_links.items():
            if perf[uid] & perf[wid]:
                label = "correct"
            else:
                near = (self._near(uid, view.nodes[uid].seq)
                        | self._near(wid, view.nodes[wid].seq))
                graph_error = (uid in error_nos or wid in error_nos
                               or bool(near & sym_diff))
                label = "false_positive" if graph_error else "error"
            self.counts[label] += 1
            log.debug("branch %s link %s->%s (pe=%s): %s", no, uid, wid,
                      pe, label)
            if pe is not None and pe <= self.CUT:
                self._pts[label].append((pe, sub_flow))
                if label == "error":
                    self._err_text.append(f"{uid}:{wid}:{pe}")

    def plot_pass(self) -> bool:
        """Emit the scatter artifact for the decisions since the last
        call (one per balance-split pass, like the reference's
        scatter_plot_pest_<i>.png); resets the point buffers."""
        self._plot_id += 1
        pts, err_text = self._pts, self._err_text
        self._reset_points()
        if self.out_dir is None or not any(pts.values()):
            return False
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except Exception:
            return False
        _, ax = plt.subplots(1, 1, figsize=(16, 16))
        styles = {"correct": dict(color="red", label="Correct"),
                  "false_positive": dict(color="blue",
                                         label="False-Positive"),
                  "error": dict(color="green", marker="^",
                                label="Error")}
        for label, style in styles.items():
            if pts[label]:
                xs, ys = zip(*pts[label])
                ax.scatter(xs, ys, s=100, **style)
        for text, (x, y) in zip(err_text, pts["error"]):
            ax.text(x, y, text, size=10)
        ax.set_xlabel("PE link count")
        ax.set_ylabel("edge flow")
        ax.set_title("split decisions: flow vs PE")
        ax.legend()
        path = f"{self.out_dir}/split_scatter_{self._plot_id}.png"
        plt.savefig(path)
        plt.close()
        self.logger.debug("split-decision scatter written: %s", path)
        return True
