#!/usr/bin/env python3
"""N=50,000 realistic benchmark + correctness lattice (round-3 deliverable).

Three pieces, one JSON (default chiprun_out/realistic_50k.json):

1. ENGINE — 50k-node synthetic graph (14.5M-entry table), 1M read
   pairs, timed end-to-end on this backend including the in-driver
   table build (e2e_reads_per_s) and with the build factored out
   (engine_reads_per_s). Sparse COO stats path throughout.

2. ORACLE AT FULL SCALE — the pure-Python reference-semantics oracle
   (tests/oracle_pe.py, itself byte-validated against the actual
   reference script at 992/2k nodes) re-run sparsely on a subsample at
   N=50,000 and compared pair-for-pair against the engine's COO result
   on the same reads. The ACTUAL reference script cannot run at this
   scale: it allocates two dense N^2 int64 matrices (40 GB at N=50k;
   VStrains_PE_Inference.py:139-140) and writes every one of the
   2 x 2.5e9 matrix cells as a text line (:193-204) — hundreds of GB.

3. ACTUAL REFERENCE AT ITS OWN CEILING — the real
   VStrains_PE_Inference.py on the same kind of graph at N=5,000 (its
   N^2 output format's practical limit, ~2x290 MB files), byte-diffed
   against our pe_info/st_info on an identical subsample; its measured
   reads/s extrapolates the 1M-pair wall given under "reference_*".

Env: R50K_NODES (50000), R50K_PAIRS (1048576), R50K_ORACLE_PAIRS
(2000), R50K_REF_NODES (5000), R50K_REF_PAIRS (20000), R50K_OUT.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

REF_SCRIPT = "/root/reference/utils/VStrains_PE_Inference.py"


_RC = str.maketrans("ACGT", "TGCA")


def _revcomp_marked(seq: str) -> str:
    """Reverse complement with every non-ACGT character mapped to '#',
    so a slice holds '#' iff its forward window had a non-ACGT base."""
    return "".join("#" if c not in "ACGT" else c
                   for c in seq).translate(_RC)[::-1]


def sparse_oracle(seqs, fwd_reads, rve_reads, kmer_size, n_nodes):
    """tests/oracle_pe.py semantics with dict (COO) accumulation so
    N=50k fits in memory. Returns (pe_dict, st_dict) keyed u*N+v.

    Two changes of representation, neither of which can change a count:
    the string k-mer table holds only k-mers that occur in the given
    reads (no other entry can ever match), and each read's per-node
    stats are dicts over the nodes it hits, visited in node order as
    oracle_pe.map_single_end visits them."""
    split_len = kmer_size + 1
    seqlens = [len(s) for s in seqs]
    t0 = time.time()
    wanted = set()
    for reads in (fwd_reads, rve_reads):
        for s in reads:
            for i in range(len(s) - split_len + 1):
                wanted.add(s[i: i + split_len])
    table = {}
    for node, seq in enumerate(seqs):
        n = len(seq)
        rc = _revcomp_marked(seq)
        for off in range(n - split_len + 1):
            kmer = seq[off: off + split_len]
            if kmer in wanted:
                table.setdefault(kmer, []).append((node, off))
            rk = rc[n - split_len - off: n - off]
            if rk in wanted and "#" not in rk:
                table.setdefault(rk, []).append((node, off))
    print(f"# oracle table: {time.time() - t0:.0f}s", file=sys.stderr)

    def saturated(seq):
        counts, coords, kidx = {}, {}, {}
        rlen = len(seq)
        for i in range(rlen - split_len + 1):
            for rid, rcord in table.get(seq[i: i + split_len], ()):
                counts[rid] = counts.get(rid, 0) + 1
                coords[rid] = min(coords.get(rid, sys.maxsize), rcord)
                kidx[rid] = min(kidx.get(rid, sys.maxsize), i)
        out = []
        for rid in sorted(counts):
            c, ki = coords[rid], kidx[rid]
            L = max(c, c - ki)
            R = min(c + seqlens[rid] - 1, c - ki + rlen - 1)
            sat = R - L - (split_len - 1) + 1
            expected = ((min(rlen, seqlens[rid]) - split_len + 1)
                        * (rlen - split_len) / rlen)
            if counts[rid] >= max(min(sat, expected), 1):
                out.append(rid)
        return out

    pe, st = {}, {}
    for fseq, rseq in zip(fwd_reads, rve_reads):
        if fseq.count("N") or rseq.count("N"):
            continue
        if len(fseq) < split_len or len(rseq) < split_len:
            continue
        lefts = saturated(fseq)
        rights = saturated(rseq)
        for ends in (lefts, rights):
            for a, i in enumerate(ends):
                for i2 in ends[a:]:
                    k = i * n_nodes + i2
                    st[k] = st.get(k, 0) + 1
        for i in lefts:
            for j in rights:
                k = i * n_nodes + j
                pe[k] = pe.get(k, 0) + 1
    return pe, st


def coo_to_dict(keys, counts):
    return {int(k): int(c) for k, c in zip(keys, counts)}


def write_gfa_fastq(base, refs, fwd, rve, n_pairs):
    gfa = os.path.join(base, "graph.gfa")
    with open(gfa, "w") as g:
        for i, seq in enumerate(refs):
            g.write(f"S\t{i}\t{seq}\tDP:f:10.0\n")
    fq_f = os.path.join(base, "sub_1.fastq")
    fq_r = os.path.join(base, "sub_2.fastq")
    for path, reads in ((fq_f, fwd), (fq_r, rve)):
        with open(path, "w") as fh:
            for i, seq in enumerate(reads[:n_pairs]):
                fh.write(f"@r{i}\n{seq}\n+\n{'I' * len(seq)}\n")
    return gfa, fq_f, fq_r


def main():
    n_nodes = int(os.environ.get("R50K_NODES", 50_000))
    n_pairs = int(os.environ.get("R50K_PAIRS", 1_048_576))
    oracle_pairs = int(os.environ.get("R50K_ORACLE_PAIRS", 2000))
    ref_nodes = int(os.environ.get("R50K_REF_NODES", 5000))
    ref_pairs = int(os.environ.get("R50K_REF_PAIRS", 20_000))
    out_path = os.environ.get(
        "R50K_OUT", os.path.join(REPO, "chiprun_out", "realistic_50k.json"))

    import jax
    from bench import synth_workload
    from vstrains_tpu.core.fastq import ReadPairBatch, _pack
    from vstrains_tpu.ops.pe_infer import (PESparseResult,
                                           build_kmer_table,
                                           infer_pe_links,
                                           write_pe_files)

    backend = jax.default_backend()
    rec = {"backend": backend, "nodes": n_nodes, "pairs": n_pairs}
    print(f"# backend={backend}", file=sys.stderr)

    # ---- 1. engine at N=50k / 1M pairs -------------------------------
    t0 = time.time()
    refs, fwd, rve, k = synth_workload(n_nodes=n_nodes, n_pairs=n_pairs,
                                       node_len=200)
    print(f"# synth: {time.time() - t0:.0f}s", file=sys.stderr)
    ids = [str(i) for i in range(n_nodes)]
    fc, fl = _pack([s.encode() for s in fwd])
    rc, rl = _pack([s.encode() for s in rve])
    bs = int(os.environ.get("R50K_BS", 16384))

    # this firecracker host suffers CPU-steal bursts that swing an
    # identical fixed numpy sort 0.4s <-> 22s back-to-back (measured);
    # a canary records the steal weather next to every host-side
    # timing, and build/engine walls are the best of 2 repetitions of
    # the same fixed work (the less steal-degraded draw)
    def canary():
        a = np.random.RandomState(0).randint(
            0, 2**31, size=20_000_000).astype(np.uint64)
        t0 = time.time()
        np.sort(a)
        return round(time.time() - t0, 2)

    rec["host_canary_sort20M_seconds"] = [canary()]
    build_s = None
    for _ in range(2):
        t0 = time.time()
        tbl = build_kmer_table(refs, k + 1)
        build_s = min(build_s or 1e9, time.time() - t0)
    rec["table_entries"] = int(tbl.num_entries)
    rec["table_build_seconds"] = round(build_s, 2)
    rec["host_canary_sort20M_seconds"].append(canary())
    print(f"# table build: {build_s:.1f}s ({tbl.num_entries} entries); "
          f"canary {rec['host_canary_sort20M_seconds']}",
          file=sys.stderr)

    # the table is built ONCE and passed in, so the engine timing below
    # is pure streaming (the old version re-built it inside the timed
    # region and subtracted a separately-measured build — on a noisy
    # 4-core host the two builds can differ 2-3x, which once produced a
    # negative "engine" rate)
    warm = ReadPairBatch(fc[:bs], fl[:bs], rc[:bs], rl[:bs], 0, 0, bs)
    t0 = time.time()
    infer_pe_links(ids, refs, warm, k, batch_size=bs, table=tbl)
    rec["warmup_seconds"] = round(time.time() - t0, 2)
    print(f"# warmup: {rec['warmup_seconds']}s", file=sys.stderr)

    batch = ReadPairBatch(fc, fl, rc, rl, 0, 0, n_pairs)
    dt = None
    for _ in range(2):
        t0 = time.time()
        res = infer_pe_links(ids, refs, batch, k, batch_size=bs,
                             table=tbl)
        dt = min(dt or 1e9, time.time() - t0)
    rec["host_canary_sort20M_seconds"].append(canary())
    assert isinstance(res, PESparseResult)
    rec["engine_mode"] = "sparse"
    rec["engine_seconds"] = round(dt, 2)
    rec["engine_reads_per_s"] = round(n_pairs / dt, 1)
    rec["e2e_seconds"] = round(dt + build_s, 2)
    rec["e2e_reads_per_s"] = round(n_pairs / (dt + build_s), 1)
    rec["link_pairs"] = int(res.pair_keys.shape[0])
    print(f"# engine: {rec['engine_reads_per_s']} reads/s "
          f"({rec['e2e_reads_per_s']} E2E incl. table build)",
          file=sys.stderr)

    # ---- 2. oracle subsample at FULL N=50k ---------------------------
    sub = ReadPairBatch(fc[:oracle_pairs], fl[:oracle_pairs],
                        rc[:oracle_pairs], rl[:oracle_pairs],
                        0, 0, oracle_pairs)
    sub_res = infer_pe_links(ids, refs, sub, k, batch_size=bs, table=tbl)
    ope, ost = sparse_oracle(refs, fwd[:oracle_pairs], rve[:oracle_pairs],
                             k, n_nodes)
    same = (coo_to_dict(sub_res.pair_keys, sub_res.pair_counts) == ope
            and coo_to_dict(sub_res.short_keys, sub_res.short_counts)
            == ost)
    rec["oracle_subsample_pairs"] = oracle_pairs
    rec["oracle_subsample_identical"] = bool(same)
    print(f"# oracle@50k identical: {same} "
          f"({len(ope)} pe / {len(ost)} st pairs)", file=sys.stderr)
    rec["reference_at_50k"] = (
        "infeasible: 2 dense 50k^2 int64 matrices (40 GB) + 5e9 output "
        "lines (VStrains_PE_Inference.py:139-140,:193-204)")

    # ---- 3. actual reference at N=5k, byte diff ----------------------
    refs5, fwd5, rve5, k5 = synth_workload(n_nodes=ref_nodes,
                                           n_pairs=ref_pairs,
                                           node_len=200)
    base = tempfile.mkdtemp(prefix="real50k_")
    gfa, fq_f, fq_r = write_gfa_fastq(base, refs5, fwd5, rve5, ref_pairs)
    ref_out = os.path.join(base, "ref_aln")
    env = dict(os.environ)
    env["PYTHONPATH"] = (f"{REPO}/shims:" + env.get("PYTHONPATH", ""))
    t0 = time.time()
    subprocess.run([sys.executable, REF_SCRIPT, "-g", gfa, "-o", ref_out,
                    "-f", fq_f, "-r", fq_r, "-k", str(k5)],
                   check=True, env=env, timeout=7200,
                   stdout=subprocess.DEVNULL)
    ref_dt = time.time() - t0
    rec["reference_nodes"] = ref_nodes
    rec["reference_subsample_pairs"] = ref_pairs
    rec["reference_reads_per_s"] = round(ref_pairs / ref_dt, 1)
    rec["reference_projected_hours_for_1M_pairs"] = round(
        n_pairs / rec["reference_reads_per_s"] / 3600, 1)
    print(f"# reference@{ref_nodes}: {rec['reference_reads_per_s']} "
          f"reads/s ({ref_dt:.0f}s)", file=sys.stderr)

    from vstrains_tpu.core.fastq import load_read_pairs
    sub_reads = load_read_pairs(fq_f, fq_r, k5 + 1, pad_to_multiple=32)
    ids5 = [str(i) for i in range(ref_nodes)]
    our5 = infer_pe_links(ids5, refs5, sub_reads, k5, batch_size=bs)
    our_out = os.path.join(base, "our_aln")
    os.makedirs(our_out, exist_ok=True)
    write_pe_files(our5, f"{our_out}/pe_info", f"{our_out}/st_info")
    ref_same = all(
        open(f"{ref_out}/{nm}", "rb").read()
        == open(f"{our_out}/{nm}", "rb").read()
        for nm in ("pe_info", "st_info"))
    rec["reference_diff_identical"] = bool(ref_same)
    rec["speedup_vs_reference"] = round(
        rec["e2e_reads_per_s"] / rec["reference_reads_per_s"], 1)
    print(f"# reference byte-diff identical: {ref_same}", file=sys.stderr)

    print(json.dumps(rec))
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as fh:
        json.dump(rec, fh, indent=2)
        fh.write("\n")
    print(f"# wrote {out_path}", file=sys.stderr)


if __name__ == "__main__":
    main()
