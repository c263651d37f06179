#!/usr/bin/env python3
"""Proof that the strain pipeline runs on an NVIDIA GPU.

    python3 chip_smoke.py               # one GPU: phases a-d
    python3 chip_smoke.py --four-cards  # four GPUs: phase e only

One process drives the card(s); it stops with a non-zero exit at the
first failure and prints no result then.

  a. device check: JAX's default device is a GPU; prints its kind, the
     card's name and power limit (nvidia-smi) and the compile cache dir.
  b. main path: simulates the 5-strain HIV labmix (773 nodes, 388,928
     pairs of 2x250 bp) from a fixed seed, runs the CLI in-process on
     the GPU, prints per-stage seconds, a second (warm) PE engine call
     of the same shape and per-strain NGA50, and requires aln/pe_info
     and strain.paths to be byte-equal to the same CLI run on the CPU
     backend.
  c. plain reference: the PE engine on the GPU over 2,000 seeded HIV
     pairs must equal tests/oracle_pe.py exactly; then the `gpu`-marked
     tests run in-process.
  d. sparse engine at the metaSPAdes 50k-node shape (14.5M-entry table,
     1,048,576 pairs), compared pair for pair on 2,000 pairs with
     tools/realistic_50k.sparse_oracle.
  e. (--four-cards) infer_pe_links_sharded at the HIV shape on a
     (data=4, model=1) mesh and infer_pe_links_sparse_sharded at the
     50k shape on (4, 1) and (2, 2), each bit-equal to the one-card
     engine.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

HIV_SEED = 0
SUBSAMPLE_SEED = 1
ORACLE_PAIRS = 2000
R50K_NODES = 50_000
R50K_PAIRS = 1 << 20


class SmokeError(Exception):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


# --------------------------------------------------------------------------
# a. device
# --------------------------------------------------------------------------

def device_check(want: int = 1):
    """The default device, which must be a GPU, with at least `want`
    GPUs present; raises SmokeError otherwise."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SmokeError(f"no GPU: JAX's default device is "
                         f"{devs[0].platform} ({devs[0].device_kind})")
    if len(devs) < want:
        raise SmokeError(f"need {want} GPUs, JAX found {len(devs)}")
    return devs[0]


def card_name_and_power() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60)
    if r.returncode != 0:
        raise SmokeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip()


def phase_device(want: int = 1):
    from vstrains_tpu.utils.jaxcache import cache_dir
    dev = device_check(want)
    log(f"[a] device_kind: {dev.device_kind}")
    log(f"[a] card (name, power limit): {card_name_and_power()}")
    log(f"[a] compile cache: {cache_dir()}")
    return dev


# --------------------------------------------------------------------------
# b. main path through the CLI
# --------------------------------------------------------------------------

COMPARED_OUTPUTS = ("aln/pe_info", "strain.paths")


def compare_outputs(dir_a: str, dir_b: str,
                    names=COMPARED_OUTPUTS):
    """[(name, equal, digest_a, digest_b)] for byte comparisons of
    output files of two CLI runs."""
    out = []
    for name in names:
        blobs = []
        for d in (dir_a, dir_b):
            with open(os.path.join(d, name), "rb") as fh:
                blobs.append(fh.read())
        da, db = (hashlib.sha256(b).hexdigest()[:16] for b in blobs)
        out.append((name, blobs[0] == blobs[1], da, db))
    return out


def run_cli(ds, out_dir: str) -> float:
    from vstrains_tpu import cli
    t0 = time.time()
    rc = cli.main(["-a", "spades", "-g", ds.gfa_path, "-p", ds.paths_path,
                   "-fwd", ds.fwd_path, "-rve", ds.rve_path,
                   "-o", out_dir])
    if rc != 0:
        raise SmokeError(f"CLI exited {rc} (output dir {out_dir})")
    return time.time() - t0


def run_cli_on_cpu(ds, out_dir: str) -> float:
    """The same CLI run with every computation on the CPU backend."""
    import jax
    prev = jax.config.jax_default_device
    jax.config.update("jax_default_device", jax.devices("cpu")[0])
    try:
        return run_cli(ds, out_dir)
    finally:
        jax.config.update("jax_default_device", prev)


def read_gfa_segments(path: str):
    ids, seqs = [], []
    with open(path) as fh:
        for line in fh:
            f = line.rstrip("\n").split("\t")
            if f and f[0] == "S":
                ids.append(f[1])
                seqs.append(f[2])
    return ids, seqs


def warm_pe_seconds(out_dir: str, ds, k: int, reps: int = 2):
    """Seconds of `reps` engine calls on the PE stage's exact inputs
    (the simplified graph and the full library), after the CLI run
    compiled that shape."""
    from vstrains_tpu.core.fastq import load_read_pairs
    from vstrains_tpu.ops.pe_infer import build_kmer_table, infer_pe_links
    ids, seqs = read_gfa_segments(os.path.join(out_dir,
                                               "gfa/s_graph_L1.gfa"))
    t0 = time.time()
    reads = load_read_pairs(ds.fwd_path, ds.rve_path, k + 1,
                            pad_to_multiple=32)
    t_load = time.time() - t0
    t0 = time.time()
    table = build_kmer_table(seqs, k + 1)
    t_table = time.time() - t0
    dts = []
    for _ in range(reps):
        t0 = time.time()
        infer_pe_links(ids, seqs, reads, k, table=table)
        dts.append(time.time() - t0)
    return t_load, t_table, dts, reads.num_pairs


def nga50_lines(out_dir: str, ds):
    from vstrains_tpu.evals.nga50 import load_fasta, nga50_report
    rep = nga50_report(load_fasta(os.path.join(out_dir, "strain.fasta")),
                       ds.true_haplotypes)
    agg = rep.pop("_aggregate")
    lines = [f"{name}: NGA50 {r['nga50']} genome fraction "
             f"{r['genome_fraction']}%" for name, r in sorted(rep.items())]
    return lines, agg


def make_hiv(work: str, coverage: float = 20000.0, seed: int = HIV_SEED):
    from vstrains_tpu.evals.hivsim import make_hiv_dataset
    t0 = time.time()
    ds = make_hiv_dataset(os.path.join(work, "hiv"), coverage=coverage,
                          seed=seed)
    log(f"[b] HIV dataset: {ds.stats} in {time.time() - t0:.1f}s")
    return ds


def phase_main_path(ds, work: str):
    out_gpu = os.path.join(work, "out_gpu")
    wall = run_cli(ds, out_gpu)
    with open(os.path.join(out_gpu, "timings.json")) as fh:
        timings = json.load(fh)
    log(f"[b] CLI on GPU: wall {wall:.2f}s, pipeline "
        f"{timings['total_seconds']}s")
    for st in timings["stages"]:
        log(f"[b]   stage {st['stage']}: {st['seconds']}s")
    t_load, t_table, dts, n_pairs = warm_pe_seconds(out_gpu, ds, ds.k)
    log(f"[b] same PE shape again ({n_pairs} pairs): FASTQ load "
        f"{t_load:.2f}s, table build {t_table:.2f}s, engine "
        + ", ".join(f"{d:.3f}s" for d in dts))
    lines, agg = nga50_lines(out_gpu, ds)
    for line in lines:
        log(f"[b]   {line}")
    log(f"[b] NGA50 aggregate: {agg}")
    if agg["refs_with_nga50"] == 0:
        raise SmokeError("no strain reached an NGA50")

    out_cpu = os.path.join(work, "out_cpu")
    wall_cpu = run_cli_on_cpu(ds, out_cpu)
    log(f"[b] same CLI run on the CPU backend: wall {wall_cpu:.2f}s")
    for name, same, dg, dc in compare_outputs(out_gpu, out_cpu):
        log(f"[b] {name}: GPU {dg} CPU {dc} "
            f"{'byte-equal' if same else 'DIFFERENT'}")
        if not same:
            raise SmokeError(f"{name} differs between GPU and CPU runs")
    return timings


# --------------------------------------------------------------------------
# c. plain reference on a subsample
# --------------------------------------------------------------------------

def read_fastq_seqs(path: str):
    with open(path) as fh:
        return [line.rstrip("\n") for i, line in enumerate(fh) if i % 4 == 1]


def subsample_pairs(fwd_path: str, rve_path: str, n: int, seed: int):
    """n seeded pairs (file order kept) as string lists."""
    fwd = read_fastq_seqs(fwd_path)
    rve = read_fastq_seqs(rve_path)
    pick = np.sort(np.random.RandomState(seed).choice(
        len(fwd), size=min(n, len(fwd)), replace=False))
    return [fwd[i] for i in pick], [rve[i] for i in pick]


def write_fastq(path: str, seqs) -> None:
    with open(path, "w") as fh:
        for i, s in enumerate(seqs):
            fh.write(f"@r{i}\n{s}\n+\n{'I' * len(s)}\n")


def engine_vs_oracle(seqs, fwd, rve, k: int, work: str):
    """Run the PE engine (through the FASTQ loader) and the pure-Python
    oracle on the same pairs; returns (equal, used_pairs, links)."""
    from tests.oracle_pe import oracle_pe_matrices
    from vstrains_tpu.core.fastq import load_read_pairs
    from vstrains_tpu.ops.pe_infer import infer_pe_links
    f_path = os.path.join(work, "sub_1.fastq")
    r_path = os.path.join(work, "sub_2.fastq")
    write_fastq(f_path, fwd)
    write_fastq(r_path, rve)
    reads = load_read_pairs(f_path, r_path, k + 1, pad_to_multiple=32)
    ids = [str(i) for i in range(len(seqs))]
    res = infer_pe_links(ids, seqs, reads, k, stats_mode="dense")
    nm, sm, n_o, s_o, u_o = oracle_pe_matrices(seqs, fwd, rve, k)
    equal = (reads.used_reads == u_o
             and np.array_equal(res.node_mat, nm)
             and np.array_equal(res.short_mat, sm))
    return equal, reads.used_reads, int(nm.sum() + sm.sum())


def run_gpu_tests() -> int:
    import pytest
    os.environ["VSTRAINS_TESTS_ON_GPU"] = "1"
    return pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                        os.path.join(REPO, "tests", "test_gpu.py")])


def phase_reference(ds, work: str, n_pairs: int = ORACLE_PAIRS):
    _, seqs = read_gfa_segments(ds.gfa_path)
    fwd, rve = subsample_pairs(ds.fwd_path, ds.rve_path, n_pairs,
                               SUBSAMPLE_SEED)
    width = max(len(s) for s in fwd + rve)
    t0 = time.time()
    equal, used, links = engine_vs_oracle(seqs, fwd, rve, ds.k, work)
    log(f"[c] engine vs tests/oracle_pe.py: {len(seqs)} nodes, "
        f"{len(fwd)} pairs ({used} used, width {width}), {links} links: "
        f"{'equal' if equal else 'DIFFERENT'} ({time.time() - t0:.1f}s)")
    if not equal:
        raise SmokeError("engine differs from the oracle")
    rc = run_gpu_tests()
    log(f"[c] gpu-marked tests: pytest exit {rc}")
    if rc != 0:
        raise SmokeError(f"gpu-marked tests failed (pytest exit {rc})")


# --------------------------------------------------------------------------
# d. sparse engine at the metaSPAdes 50k shape
# --------------------------------------------------------------------------

def make_50k(n_nodes: int, n_pairs: int):
    from bench import synth_workload
    from vstrains_tpu.core.fastq import ReadPairBatch, _pack
    t0 = time.time()
    refs, fwd, rve, k = synth_workload(n_nodes=n_nodes, n_pairs=n_pairs,
                                       node_len=200)
    fc, fl = _pack([s.encode() for s in fwd])
    rc, rl = _pack([s.encode() for s in rve])
    batch = ReadPairBatch(fc, fl, rc, rl, 0, 0, n_pairs)
    log(f"[d] 50k-shape data: {n_nodes} nodes, {n_pairs} pairs in "
        f"{time.time() - t0:.1f}s")
    return refs, fwd, rve, k, batch


def sub_batch(batch, n: int):
    from vstrains_tpu.core.fastq import ReadPairBatch
    return ReadPairBatch(batch.fwd_codes[:n], batch.fwd_len[:n],
                         batch.rve_codes[:n], batch.rve_len[:n], 0, 0, n)


def coo_dict(keys, counts):
    return {int(k): int(c) for k, c in zip(keys, counts)}


def coo_equal(a, b) -> bool:
    return all(np.array_equal(getattr(a, f), getattr(b, f))
               for f in ("pair_keys", "pair_counts", "short_keys",
                         "short_counts"))


def phase_sparse(n_nodes: int = R50K_NODES, n_pairs: int = R50K_PAIRS,
                 oracle_pairs: int = ORACLE_PAIRS, stats_mode: str = "auto"):
    from tools.realistic_50k import sparse_oracle
    from vstrains_tpu.ops.pe_infer import (PESparseResult,
                                           build_kmer_table,
                                           infer_pe_links)
    refs, fwd, rve, k, batch = make_50k(n_nodes, n_pairs)
    ids = [str(i) for i in range(n_nodes)]
    t0 = time.time()
    table = build_kmer_table(refs, k + 1)
    log(f"[d] table: {table.num_entries} entries, max_dup "
        f"{table.max_dup}, built in {time.time() - t0:.2f}s")
    for rep in ("cold", "warm"):
        t0 = time.time()
        res = infer_pe_links(ids, refs, batch, k, table=table,
                             stats_mode=stats_mode)
        dt = time.time() - t0
        log(f"[d] engine ({rep}): {dt:.2f}s, {n_pairs / dt:.1f} pairs/s, "
            f"{len(res.pair_keys)} PE links")
    if not isinstance(res, PESparseResult):
        raise SmokeError("the 50k shape did not take the sparse engine")
    sub = infer_pe_links(ids, refs, sub_batch(batch, oracle_pairs), k,
                         table=table, stats_mode="sparse")
    t0 = time.time()
    ope, ost = sparse_oracle(refs, fwd[:oracle_pairs], rve[:oracle_pairs],
                             k, n_nodes)
    same = (coo_dict(sub.pair_keys, sub.pair_counts) == ope
            and coo_dict(sub.short_keys, sub.short_counts) == ost)
    log(f"[d] sparse engine vs sparse_oracle on {oracle_pairs} pairs "
        f"({len(ope)} PE / {len(ost)} same-end links): "
        f"{'equal' if same else 'DIFFERENT'} (oracle "
        f"{time.time() - t0:.1f}s)")
    if not same:
        raise SmokeError("sparse engine differs from sparse_oracle")


# --------------------------------------------------------------------------
# e. four cards
# --------------------------------------------------------------------------

def phase_four_cards(ds, n_nodes: int = R50K_NODES,
                     n_pairs: int = R50K_PAIRS):
    from vstrains_tpu.core.fastq import load_read_pairs
    from vstrains_tpu.ops.pe_infer import infer_pe_links
    from vstrains_tpu.parallel.mesh import (infer_pe_links_sharded,
                                            infer_pe_links_sparse_sharded,
                                            make_mesh)
    ids, seqs = read_gfa_segments(ds.gfa_path)
    reads = load_read_pairs(ds.fwd_path, ds.rve_path, ds.k + 1,
                            pad_to_multiple=32)
    one = infer_pe_links(ids, seqs, reads, ds.k, stats_mode="dense")
    t0 = time.time()
    shd = infer_pe_links_sharded(ids, seqs, reads, ds.k,
                                 mesh=make_mesh(data=4, model=1),
                                 stats_mode="dense")
    same = (np.array_equal(one.node_mat, shd.node_mat)
            and np.array_equal(one.short_mat, shd.short_mat))
    log(f"[e] HIV dense sharded (data=4, model=1), {reads.num_pairs} "
        f"pairs: {time.time() - t0:.2f}s, "
        f"{'bit-equal' if same else 'DIFFERENT'} to one card")
    if not same:
        raise SmokeError("sharded HIV engine differs from one card")

    refs, _, _, k, batch = make_50k(n_nodes, n_pairs)
    ids = [str(i) for i in range(n_nodes)]
    one = infer_pe_links(ids, refs, batch, k, stats_mode="sparse")
    for data, model in ((4, 1), (2, 2)):
        t0 = time.time()
        shd = infer_pe_links_sparse_sharded(
            ids, refs, batch, k, mesh=make_mesh(data=data, model=model))
        same = coo_equal(one, shd)
        log(f"[e] 50k sparse sharded (data={data}, model={model}): "
            f"{time.time() - t0:.2f}s, "
            f"{'bit-equal' if same else 'DIFFERENT'} to one card")
        if not same:
            raise SmokeError(f"sharded sparse engine ({data}x{model}) "
                             "differs from one card")


# --------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded engines on four GPUs and "
                         "the one-card runs they are compared with")
    args = ap.parse_args(argv)
    want = 4 if args.four_cards else 1
    t_start = time.time()
    try:
        import jax
        dev = phase_device(want)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
            ds = make_hiv(work)
            if args.four_cards:
                phase_four_cards(ds)
            else:
                phase_main_path(ds, work)
                phase_reference(ds, work)
                phase_sparse()
    except Exception as exc:  # every failure ends the run, loudly
        print(f"chip_smoke FAILED: {type(exc).__name__}: {exc}",
              file=sys.stderr, flush=True)
        return 1
    log(f"total {time.time() - t_start:.1f}s")
    log(f"card (name, power limit): {card_name_and_power()}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
