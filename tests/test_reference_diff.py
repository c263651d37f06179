"""Byte-level A/B diff against the ACTUAL reference PE-inference script.

The reference's hot kernel (/root/reference/utils/VStrains_PE_Inference.py)
imports only stdlib + numpy, so it runs in this environment unmodified.
These tests run it as a child process on synthetic datasets and assert that
our engine's `pe_info` / `st_info` output files are byte-identical —
upgrading every "oracle-equal" claim in this suite to "reference-equal".

Covered divergence surfaces:
  * hit counting + min-coord/min-kindex accumulation (PE_Inference.py:24-31)
  * the saturation formula incl. float-vs-int boundary (:39-47)
  * pair-loop link accumulation vs our device matmuls (:174-188)
  * N-read / short-read filtering (:160-165)
  * the N^2 `u:v:count` file format (:190-207)
"""

import os
import subprocess
import sys

import pytest

from vstrains_tpu import pe_cli
from vstrains_tpu.evals.synth import make_dataset

REF_SCRIPT = "/root/reference/utils/VStrains_PE_Inference.py"

pytestmark = pytest.mark.skipif(
    not os.path.exists(REF_SCRIPT),
    reason="reference checkout not available")


def _run_reference(gfa, out_dir, fwd, rve, k):
    subprocess.run(
        [sys.executable, REF_SCRIPT, "-g", str(gfa), "-o", str(out_dir),
         "-f", str(fwd), "-r", str(rve), "-k", str(k)],
        check=True, capture_output=True, timeout=600)


def _diff_files(ref_dir, ours_dir):
    for name in ("pe_info", "st_info"):
        ref_bytes = open(os.path.join(ref_dir, name), "rb").read()
        our_bytes = open(os.path.join(ours_dir, name), "rb").read()
        assert our_bytes == ref_bytes, (
            f"{name} differs from the reference implementation "
            f"({len(ref_bytes)} vs {len(our_bytes)} bytes)")


def _run_both_and_diff(ds, tmp_path, k, batch_size=1024):
    ref_out = tmp_path / "ref_aln"
    our_out = tmp_path / "our_aln"
    _run_reference(ds.gfa_path, ref_out, ds.fwd_path, ds.rve_path, k)
    rc = pe_cli.main(["-g", ds.gfa_path, "-o", str(our_out),
                      "-f", ds.fwd_path, "-r", ds.rve_path, "-k", str(k),
                      "--batch-size", str(batch_size)])
    assert rc == 0
    _diff_files(str(ref_out), str(our_out))


def test_reference_diff_clean_2strain(tmp_path):
    ds = make_dataset(str(tmp_path / "ds"), num_strains=2, k=21,
                      pairs_per_strain=400, seed=11)
    _run_both_and_diff(ds, tmp_path, k=21)


def test_reference_diff_errors_3strain(tmp_path):
    """Sequencing errors produce near-miss k-mers that stress the
    saturation boundary (partial window matches per node)."""
    ds = make_dataset(str(tmp_path / "ds"), num_strains=3, k=21,
                      pairs_per_strain=300, error_rate=0.01,
                      contig_mode="split", seed=23)
    _run_both_and_diff(ds, tmp_path, k=21)


def test_reference_diff_n_and_short_reads(tmp_path):
    """Pairs with 'N' bases or a too-short mate must be dropped by both
    implementations (PE_Inference.py:160-165) without shifting any
    counts; also uses an uneven batch size to cover padding."""
    ds = make_dataset(str(tmp_path / "ds"), num_strains=2, k=21,
                      pairs_per_strain=150, read_len=60, seed=37)
    extra = [
        # fwd mate contains N -> n_reads
        ("ACGTNACGT" + "A" * 51, "C" * 60),
        # rve mate shorter than k+1 -> short_reads
        ("G" * 60, "ACGTACGT"),
        # both clean but alien sequence: maps to nothing
        ("T" * 60, "G" * 60),
    ]
    with open(ds.fwd_path, "a") as f1, open(ds.rve_path, "a") as f2:
        for i, (fs, rs) in enumerate(extra):
            f1.write(f"@extra{i}/1\n{fs}\n+\n{'I' * len(fs)}\n")
            f2.write(f"@extra{i}/2\n{rs}\n+\n{'I' * len(rs)}\n")
    _run_both_and_diff(ds, tmp_path, k=21, batch_size=256)


def test_reference_diff_long_nodes_k55(tmp_path):
    """Larger k (the real SPAdes regime) and longer nodes."""
    ds = make_dataset(str(tmp_path / "ds"), num_strains=2, k=55,
                      anchor_len=700, variant_len=260, read_len=150,
                      insert_len=320, pairs_per_strain=250, seed=53)
    _run_both_and_diff(ds, tmp_path, k=55)
