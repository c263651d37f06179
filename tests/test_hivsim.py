"""evals/hivsim.py — the HIV-labmix-fidelity dataset generator.

Checks the generator's structural contracts (the full-coverage benchmark
itself runs via tools/hiv_fidelity.py and chip_smoke.py):

  * the de-Bruijn unitig graph rebuilds every strain genome exactly
    (asserted inside the generator), parses as valid GFA, and each
    strain path walks real edges;
  * backbone identity >= 90% (the labmix regime;
    /root/reference/README.md:209-211);
  * contigs are read-scale fragments (no full-genome giveaways) and
    reconstruct as subsequences of their strain genomes;
  * the tiny-coverage dataset round-trips through OUR full pipeline and
    the output scores > 0 NGA50 on >= 4/5 strains.
"""

import os
import re

import numpy as np
import pytest

from vstrains_tpu.evals.hivsim import make_hiv_dataset


@pytest.fixture(scope="module")
def ds(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("hivsim"))
    return make_hiv_dataset(out, coverage=400.0, seed=0)


def test_identity_backbone(ds):
    assert ds.identity["min_pairwise_identity"] >= 0.90
    assert ds.identity["mean_pairwise_identity"] < 0.995  # not trivial


def test_gfa_parses_and_paths_walk_edges(ds):
    from vstrains_tpu.core.gfa import parse_gfa
    segs, links = parse_gfa(ds.gfa_path)
    assert all(l.overlap == ds.k == 55 for l in links)
    names = {s.name for s in segs}
    edges = {(l.src, l.dst) for l in links}
    for strain, path in ds.strain_paths.items():
        assert set(path) <= names
        for a, b in zip(path, path[1:]):
            assert (a, b) in edges, f"{strain}: missing edge {a}->{b}"


def test_strain_paths_rebuild_genomes(ds):
    from vstrains_tpu.core.gfa import parse_gfa
    segs, _ = parse_gfa(ds.gfa_path)
    seq = {s.name: s.seq for s in segs}
    k = ds.k
    for strain, path in ds.strain_paths.items():
        # consecutive unitigs overlap by km-1 == k characters
        rec = seq[path[0]]
        for n in path[1:]:
            rec += seq[n][k:]
        assert rec == ds.true_haplotypes[strain]


def test_contigs_are_fragments_not_genomes(ds):
    text = open(ds.paths_path).read()
    lens = [int(m.group(1))
            for m in re.finditer(r"length_(\d+)_cov", text)][::2]
    gmax = max(len(s) for s in ds.true_haplotypes.values())
    assert max(lens) < 0.5 * gmax, "a contig gives away a whole genome"
    assert len(lens) >= 20, "fragmentation too coarse to be realistic"


def test_contigs_validate_against_graph(ds):
    import logging
    from vstrains_tpu.core.canon import load_gfa_canonized
    from vstrains_tpu.algos.preprocess import reindexing
    from vstrains_tpu.core.contig_io import spades_paths_parser
    log = logging.getLogger("hivsim_test")
    view = load_gfa_canonized(ds.gfa_path, log).compact()
    view, idx_mapping = reindexing(view)
    contig_dict, _ = spades_paths_parser(view, idx_mapping,
                                         ds.paths_path, min_len=250,
                                         min_cov=0, logger=log)
    assert len(contig_dict) >= 10
    # every parsed contig walks live graph edges
    for cno, (contig, clen, ccov) in contig_dict.items():
        for a, b in zip(contig, contig[1:]):
            assert (a, b) in view.edges, f"contig {cno}: {a}->{b}"


def test_reads_have_error_profile(ds):
    # qualities must vary (degrading profile), some Ns must exist
    lines = open(ds.fwd_path).read().splitlines()
    quals = lines[3::4]
    seqs = lines[1::4]
    assert len(set(quals[0])) > 3, "quality string is flat"
    n_frac = sum(s.count("N") for s in seqs) / sum(len(s) for s in seqs)
    assert 0 < n_frac < 0.01
    assert all(len(s) == 250 for s in seqs[:100])


@pytest.mark.slow
def test_tiny_e2e_pipeline_recovers_strains(tmp_path):
    import logging
    from types import SimpleNamespace
    from vstrains_tpu import pipeline
    from vstrains_tpu.evals.nga50 import load_fasta, nga50_report

    ds = make_hiv_dataset(str(tmp_path / "data"), coverage=400.0,
                          genome_len=4000, seed=2)
    outdir = str(tmp_path / "out")
    for sub in ["gfa", "tmp", "paf", "aln"]:
        os.makedirs(os.path.join(outdir, sub), exist_ok=True)
    args = SimpleNamespace(
        gfa_file=ds.gfa_path, path_file=ds.paths_path,
        fwd=ds.fwd_path, rve=ds.rve_path, output_dir=outdir,
        min_cov=None, min_len=250, dev=False, pe_batch_size=2048,
        resume=False)
    pipeline.run(args, logging.getLogger("hivsim_e2e"))
    rep = nga50_report(load_fasta(os.path.join(outdir, "strain.fasta")),
                       load_fasta(ds.truth_path), k=31, min_block=500)
    agg = rep.pop("_aggregate")
    assert agg["refs_with_nga50"] >= 4, rep


def test_benchmark_shapes_registry_structural():
    """Every published benchmark shape (README.md:204-211) generates a
    valid dataset at probe coverage: graph parses, strain paths rebuild
    the genomes, divergence lands in the shape's regime."""
    import tempfile

    from vstrains_tpu.core.gfa import parse_gfa
    from vstrains_tpu.evals.hivsim import (BENCH_SHAPES,
                                           make_benchmark_dataset)

    assert set(BENCH_SHAPES) == {"polio6", "hcv10", "zikv15", "sars2"}
    for shape, spec in BENCH_SHAPES.items():
        with tempfile.TemporaryDirectory() as d:
            ds = make_benchmark_dataset(d, shape, coverage=120.0)
            assert len(ds.true_haplotypes) == spec["n_strains"]
            segs, links = parse_gfa(ds.gfa_path)
            seq = {s.name: s.seq for s in segs}
            edges = {(l.src, l.dst) for l in links}
            for strain, path in ds.strain_paths.items():
                rec = seq[path[0]]
                for a, b in zip(path, path[1:]):
                    assert (a, b) in edges
                    rec += seq[b][ds.k:]
                assert rec == ds.true_haplotypes[strain]
            if shape == "sars2":
                assert ds.identity["min_pairwise_identity"] >= 0.995
            else:
                assert 0.88 <= ds.identity["min_pairwise_identity"] < 0.99


def test_sars2_tiny_e2e_recovers_both_strains(tmp_path):
    """The near-identical 2-strain SARS-CoV-2 wastewater shape (99.7%
    identity, distinct abundances) round-trips through our pipeline."""
    import logging
    from types import SimpleNamespace

    from vstrains_tpu import pipeline
    from vstrains_tpu.evals.hivsim import make_benchmark_dataset
    from vstrains_tpu.evals.nga50 import load_fasta, nga50_report

    ds = make_benchmark_dataset(str(tmp_path / "data"), "sars2",
                                coverage=300.0, genome_len=6000, seed=3)
    outdir = str(tmp_path / "out")
    for sub in ["gfa", "tmp", "paf", "aln"]:
        os.makedirs(os.path.join(outdir, sub), exist_ok=True)
    args = SimpleNamespace(
        gfa_file=ds.gfa_path, path_file=ds.paths_path,
        fwd=ds.fwd_path, rve=ds.rve_path, output_dir=outdir,
        min_cov=None, min_len=250, dev=False, pe_batch_size=2048,
        resume=False)
    pipeline.run(args, logging.getLogger("sars2_e2e"))
    rep = nga50_report(load_fasta(os.path.join(outdir, "strain.fasta")),
                       load_fasta(ds.truth_path), k=31, min_block=500)
    agg = rep.pop("_aggregate")
    assert agg["refs_with_nga50"] == 2, rep
