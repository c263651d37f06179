"""chip_smoke.py's CPU-side parts: its device check refuses the CPU, and
its comparison helpers and plain references work on tiny data."""

import io
import os
from contextlib import redirect_stdout

import numpy as np
import pytest

import chip_smoke
from tests.oracle_pe import oracle_pe_matrices
from tests.test_pe_infer import _random_refs, _sample_reads
from tools.realistic_50k import sparse_oracle


def test_device_check_refuses_cpu():
    with pytest.raises(chip_smoke.SmokeError, match="no GPU"):
        chip_smoke.device_check()


def test_main_fails_without_gpu_and_prints_no_result():
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = chip_smoke.main([])
    assert rc != 0
    assert '"ok"' not in buf.getvalue()


def test_compare_outputs(tmp_path):
    for d in ("a", "b"):
        os.makedirs(tmp_path / d / "aln")
        (tmp_path / d / "aln" / "pe_info").write_text("1:2:3\n")
        (tmp_path / d / "strain.paths").write_text("1\n")
    got = chip_smoke.compare_outputs(str(tmp_path / "a"), str(tmp_path / "b"))
    assert [g[:2] for g in got] == [("aln/pe_info", True),
                                    ("strain.paths", True)]
    (tmp_path / "b" / "strain.paths").write_text("2\n")
    got = chip_smoke.compare_outputs(str(tmp_path / "a"), str(tmp_path / "b"))
    assert [g[1] for g in got] == [True, False]
    assert got[1][2] != got[1][3]


def test_subsample_pairs_is_seeded(tmp_path):
    seqs = [f"ACGT{'A' * i}" for i in range(50)]
    chip_smoke.write_fastq(str(tmp_path / "f.fq"), seqs)
    chip_smoke.write_fastq(str(tmp_path / "r.fq"), seqs[::-1])
    a = chip_smoke.subsample_pairs(str(tmp_path / "f.fq"),
                                   str(tmp_path / "r.fq"), 10, seed=3)
    b = chip_smoke.subsample_pairs(str(tmp_path / "f.fq"),
                                   str(tmp_path / "r.fq"), 10, seed=3)
    assert a == b and len(a[0]) == 10
    idx = [seqs.index(s) for s in a[0]]
    assert idx == sorted(idx)  # file order kept
    assert all(r == seqs[49 - i] for r, i in zip(a[1], idx))


def test_engine_vs_oracle_helper(tmp_path):
    rng = np.random.RandomState(2)
    k = 11
    refs = _random_refs(rng, 5, [80, 90, 100, 110, 120])
    fwd, rve = _sample_reads(rng, refs, 60, 30, k)
    equal, used, links = chip_smoke.engine_vs_oracle(refs, fwd, rve, k,
                                                     str(tmp_path))
    assert equal and used > 0 and links > 0


def test_sparse_oracle_matches_dense_oracle():
    rng = np.random.RandomState(6)
    k = 11
    motif = _random_refs(rng, 1, [30])[0]
    refs = [motif + s for s in _random_refs(rng, 6, [60] * 6)]
    fwd, rve = _sample_reads(rng, refs, 80, 30, k)
    n = len(refs)
    pe, st = sparse_oracle(refs, fwd, rve, k, n)
    nm, sm, *_ = oracle_pe_matrices(refs, fwd, rve, k)
    for d, m in ((pe, nm), (st, sm)):
        dense = np.zeros((n, n), np.int64)
        for key, c in d.items():
            dense[key // n, key % n] = c
        np.testing.assert_array_equal(dense, m)


def test_phase_sparse_tiny():
    chip_smoke.phase_sparse(n_nodes=40, n_pairs=600, oracle_pairs=200,
                            stats_mode="sparse")


def test_cli_cpu_leg_matches(tmp_path):
    """run_cli_on_cpu gives the same bytes as run_cli and restores the
    default device afterwards."""
    import jax

    from vstrains_tpu.evals.synth import make_dataset
    ds = make_dataset(str(tmp_path / "data"), num_strains=2,
                      num_bubbles=2, pairs_per_strain=150, seed=4)
    before = jax.config.jax_default_device
    chip_smoke.run_cli(ds, str(tmp_path / "a"))
    chip_smoke.run_cli_on_cpu(ds, str(tmp_path / "b"))
    assert jax.config.jax_default_device is before
    assert all(same for _, same, _, _ in chip_smoke.compare_outputs(
        str(tmp_path / "a"), str(tmp_path / "b")))
