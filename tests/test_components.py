"""Per-component parallel extraction on a multi-component graph."""

import logging
import os
from types import SimpleNamespace

import pytest

from vstrains_tpu import pipeline
from vstrains_tpu.core.graph import new_view
from vstrains_tpu.evals.synth import make_multi_component_dataset
from vstrains_tpu.parallel.components import weakly_connected_components

_LOG = logging.getLogger("components")


def test_weakly_connected_components():
    v = new_view()
    a = v.add_vertex("a", 1.0, "AA")
    b = v.add_vertex("b", 1.0, "CC")
    c = v.add_vertex("c", 1.0, "GG")
    d = v.add_vertex("d", 1.0, "TT")
    v.add_edge(a, b, 0)
    v.add_edge(d, c, 0)
    comps = weakly_connected_components(v)
    assert comps == [["a", "b"], ["c", "d"]]


def _read_fasta(path):
    seqs = {}
    name = None
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line.startswith(">"):
                name = line[1:]
                seqs[name] = ""
            elif line and name is not None:
                seqs[name] += line
    return seqs


@pytest.mark.slow
@pytest.mark.parametrize("workers", [1, 2])
def test_multicomponent_recovery(tmp_path, workers):
    ds = make_multi_component_dataset(
        str(tmp_path / "data"), n_components=2, num_strains=2,
        num_bubbles=2, pairs_per_strain=300, seed=31)
    out = tmp_path / f"out{workers}"
    for sub in ["gfa", "tmp", "paf", "aln"]:
        os.makedirs(out / sub)
    args = SimpleNamespace(
        gfa_file=ds.gfa_path, path_file=ds.paths_path,
        fwd=ds.fwd_path, rve=ds.rve_path,
        output_dir=str(out), min_cov=None, min_len=250, dev=False,
        pe_batch_size=256, resume=False, per_component=True,
        component_workers=workers)
    pipeline.run(args, _LOG)
    seqs = _read_fasta(out / "strain.fasta")
    recovered = set(seqs.values())
    hits = sum(1 for hap in ds.true_haplotypes if hap in recovered)
    assert hits == 4, f"only {hits}/4 haplotypes reconstructed"


@pytest.mark.slow
def test_fifteen_strain_metaviral(tmp_path):
    """The 15-strain metaviral analogue (BASELINE config 5): 3 components
    x 5 strains via metaSPAdes-style multi-component graph, per-component
    extraction with 2 workers."""
    ds = make_multi_component_dataset(
        str(tmp_path / "data"), n_components=3, num_strains=5,
        num_bubbles=3, pairs_per_strain=300,
        abundances=(20.0, 40.0, 60.0, 80.0, 100.0), seed=3)
    out = tmp_path / "out15"
    for sub in ["gfa", "tmp", "paf", "aln"]:
        os.makedirs(out / sub)
    args = SimpleNamespace(
        gfa_file=ds.gfa_path, path_file=ds.paths_path,
        fwd=ds.fwd_path, rve=ds.rve_path,
        output_dir=str(out), min_cov=None, min_len=250, dev=False,
        pe_batch_size=512, resume=False, per_component=True,
        component_workers=2)
    pipeline.run(args, _LOG)
    seqs = _read_fasta(out / "strain.fasta")
    recovered = set(seqs.values())
    hits = sum(1 for hap in ds.true_haplotypes if hap in recovered)
    assert hits == 15, f"only {hits}/15 haplotypes reconstructed"


@pytest.mark.slow
def test_two_process_component_dispatch(tmp_path):
    """Two real jax.distributed processes run the full pipeline with
    --per-component on a 3-component graph: components are sharded
    round-robin across processes and the strain dicts exchanged
    (run_components_multihost), so both processes — and a single-process
    run — must produce identical strain.fasta files."""
    import socket
    import subprocess
    import sys as _sys

    ds = make_multi_component_dataset(
        str(tmp_path / "data"), n_components=3, num_strains=2,
        num_bubbles=2, pairs_per_strain=300, seed=13)
    data_dir = str(tmp_path / "data")

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coord = f"127.0.0.1:{port}"
    worker = os.path.join(os.path.dirname(__file__),
                          "dist_components_worker.py")
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    outs = [str(tmp_path / f"out_p{pid}") for pid in (0, 1)]
    procs = [subprocess.Popen(
        [_sys.executable, worker, coord, "2", str(pid), data_dir,
         outs[pid]], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for pid in (0, 1)]
    logs = []
    for p in procs:
        out, _ = p.communicate(timeout=600)
        logs.append(out.decode(errors="replace"))
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)

    # single-process run for comparison
    solo = tmp_path / "out_solo"
    for sub in ["gfa", "tmp", "paf", "aln"]:
        os.makedirs(solo / sub)
    args = SimpleNamespace(
        gfa_file=ds.gfa_path, path_file=ds.paths_path,
        fwd=ds.fwd_path, rve=ds.rve_path,
        output_dir=str(solo), min_cov=None, min_len=250, dev=False,
        pe_batch_size=256, resume=False, per_component=True,
        component_workers=1)
    pipeline.run(args, _LOG)

    ref = _read_fasta(solo / "strain.fasta")
    for out in outs:
        got = _read_fasta(os.path.join(out, "strain.fasta"))
        assert got == ref, f"{out} diverges from single-process output"


def _worker_platform():
    import os

    import jax
    return os.environ.get("JAX_PLATFORMS"), jax.devices()[0].platform


def test_component_workers_stay_off_the_accelerator(monkeypatch):
    """Worker processes pin JAX to the CPU backend before any backend
    starts, whatever platform the parent asked for, so they never open
    the parent's card."""
    from vstrains_tpu.parallel.components import host_worker_pool
    monkeypatch.setenv("JAX_PLATFORMS", "cuda")
    with host_worker_pool(1) as ex:
        assert ex.submit(_worker_platform).result(timeout=120) == (
            "cpu", "cpu")
