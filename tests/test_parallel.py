"""Multi-device sharding: DPxTP PE inference and SP window hashing must be
bit-identical to the single-device path on the 8-device virtual CPU mesh."""

import numpy as np
import pytest

from tests.test_pe_infer import (_make_batch, _random_refs, _sample_reads)
from vstrains_tpu.core.seq import encode_seq, window_hashes_np
from vstrains_tpu.ops.pe_infer import infer_pe_links
from vstrains_tpu.parallel.mesh import (infer_pe_links_sharded, make_mesh,
                                        sp_window_hashes)


@pytest.mark.parametrize("data,model", [(8, 1), (4, 2), (2, 4)])
def test_sharded_pe_bitwise_equal(eight_devices, data, model):
    rng = np.random.RandomState(17)
    k = 11
    refs = _random_refs(rng, 5, [70, 90, 110, 130, 150])
    fwd, rve = _sample_reads(rng, refs, 100, 35, k)
    batch = _make_batch(fwd, rve, k + 1)
    ids = [str(i) for i in range(5)]

    serial = infer_pe_links(ids, refs, batch, k, batch_size=64)
    mesh = make_mesh(data=data, model=model, devices=eight_devices)
    sharded = infer_pe_links_sharded(ids, refs, batch, k, mesh,
                                     batch_size=48)
    np.testing.assert_array_equal(serial.node_mat, sharded.node_mat)
    np.testing.assert_array_equal(serial.short_mat, sharded.short_mat)


@pytest.mark.parametrize("data,model", [(8, 1), (4, 2), (2, 4)])
def test_sortfill_sharded_with_duplicates_bit_equal(eight_devices, data,
                                                    model):
    """The sharded sortfill steps (read-sharded DP and table-sharded TP
    with per-shard payloads) match single-chip on a graph with duplicate
    k-mer runs — multi-rank payloads, runs free to straddle TP shard
    boundaries."""
    rng = np.random.RandomState(29)
    k = 11
    motif = _random_refs(rng, 1, [40])[0]
    refs = [motif + _random_refs(rng, 1, [60])[0] for _ in range(6)]
    fwd, rve = _sample_reads(rng, refs, 96, 30, k)
    batch = _make_batch(fwd, rve, k + 1)
    ids = [str(i) for i in range(6)]
    from vstrains_tpu.ops.pe_infer import build_kmer_table
    assert build_kmer_table(refs, k + 1).max_dup > 1

    serial = infer_pe_links(ids, refs, batch, k, batch_size=64)
    mesh = make_mesh(data=data, model=model, devices=eight_devices)
    sharded = infer_pe_links_sharded(ids, refs, batch, k, mesh,
                                     batch_size=48)
    np.testing.assert_array_equal(serial.node_mat, sharded.node_mat)
    np.testing.assert_array_equal(serial.short_mat, sharded.short_mat)


@pytest.mark.parametrize("data,model", [(8, 1), (4, 2)])
def test_classic_join_paths_still_equal(eight_devices, monkeypatch,
                                        data, model):
    """The classic DP/TP join paths (taken when a graph exceeds the
    sortfill packing) remain bit-identical to single-chip."""
    import vstrains_tpu.parallel.mesh as M
    monkeypatch.setattr(M, "_SORTFILL_MAX_DUP", 0)  # force classic
    rng = np.random.RandomState(31)
    k = 11
    refs = _random_refs(rng, 4, [80, 100, 120, 140])
    fwd, rve = _sample_reads(rng, refs, 64, 30, k)
    batch = _make_batch(fwd, rve, k + 1)
    ids = [str(i) for i in range(4)]
    serial = infer_pe_links(ids, refs, batch, k, batch_size=32)
    mesh = make_mesh(data=data, model=model, devices=eight_devices)
    sharded = infer_pe_links_sharded(ids, refs, batch, k, mesh,
                                     batch_size=48)
    np.testing.assert_array_equal(serial.node_mat, sharded.node_mat)
    np.testing.assert_array_equal(serial.short_mat, sharded.short_mat)


def _assert_sparse_equal(a, b):
    np.testing.assert_array_equal(a.pair_keys, b.pair_keys)
    np.testing.assert_array_equal(a.pair_counts, b.pair_counts)
    np.testing.assert_array_equal(a.short_keys, b.short_keys)
    np.testing.assert_array_equal(a.short_counts, b.short_counts)


@pytest.mark.parametrize("data,model", [(8, 1), (4, 2), (2, 4)])
def test_sparse_sharded_bit_equal(eight_devices, data, model):
    """The sharded sparse COO engine (DP over reads x TP over the table)
    equals the single-chip sparse engine bit-for-bit on every mesh
    shape — the large-N multi-chip path (VERDICT r4 ask #1)."""
    from vstrains_tpu.ops.pe_infer import PESparseResult
    from vstrains_tpu.parallel.mesh import infer_pe_links_sparse_sharded

    rng = np.random.RandomState(47)
    k = 11
    refs = _random_refs(rng, 6, [70, 90, 110, 130, 150, 170])
    fwd, rve = _sample_reads(rng, refs, 120, 35, k)
    batch = _make_batch(fwd, rve, k + 1)
    ids = [str(i) for i in range(6)]

    serial = infer_pe_links(ids, refs, batch, k, batch_size=64,
                            stats_mode="sparse")
    assert isinstance(serial, PESparseResult)
    mesh = make_mesh(data=data, model=model, devices=eight_devices)
    sharded = infer_pe_links_sparse_sharded(ids, refs, batch, k, mesh,
                                            batch_size=48)
    _assert_sparse_equal(serial, sharded)


@pytest.mark.parametrize("data,model", [(4, 2), (2, 4)])
def test_sparse_sharded_classic_join_bit_equal(eight_devices,
                                               monkeypatch, data, model):
    """The sharded sparse engine's classic-join path (graphs past the
    sortfill packing) also matches single-chip, including duplicate
    k-mer runs straddling TP table-shard boundaries."""
    import vstrains_tpu.parallel.mesh as M
    monkeypatch.setattr(M, "_SORTFILL_MAX_DUP", 0)  # force classic
    rng = np.random.RandomState(53)
    k = 11
    motif = _random_refs(rng, 1, [40])[0]
    refs = [motif + _random_refs(rng, 1, [60])[0] for _ in range(5)]
    fwd, rve = _sample_reads(rng, refs, 96, 30, k)
    batch = _make_batch(fwd, rve, k + 1)
    ids = [str(i) for i in range(5)]
    serial = infer_pe_links(ids, refs, batch, k, batch_size=64,
                            stats_mode="sparse")
    mesh = make_mesh(data=data, model=model, devices=eight_devices)
    sharded = M.infer_pe_links_sparse_sharded(ids, refs, batch, k, mesh,
                                              batch_size=48)
    _assert_sparse_equal(serial, sharded)


@pytest.mark.parametrize("data,model", [(8, 1), (2, 4)])
def test_sparse_sharded_cap_overflow_retry(eight_devices, data, model):
    """Tiny caps force the overflow-retry path (both the saturated-node
    cap and the TP candidate cap); results must be unchanged."""
    from vstrains_tpu.parallel.mesh import infer_pe_links_sparse_sharded

    rng = np.random.RandomState(59)
    k = 11
    refs = _random_refs(rng, 6, [80, 90, 100, 110, 120, 130])
    fwd, rve = _sample_reads(rng, refs, 80, 35, k)
    batch = _make_batch(fwd, rve, k + 1)
    ids = [str(i) for i in range(6)]
    serial = infer_pe_links(ids, refs, batch, k, batch_size=64,
                            stats_mode="sparse")
    mesh = make_mesh(data=data, model=model, devices=eight_devices)
    sharded = infer_pe_links_sparse_sharded(ids, refs, batch, k, mesh,
                                            batch_size=48, cap=1,
                                            cap_c=2)
    _assert_sparse_equal(serial, sharded)


def test_sharded_auto_routes_to_sparse(eight_devices):
    """infer_pe_links_sharded's dense/sparse cutover mirrors the
    single-chip driver: stats_mode='sparse' returns a PESparseResult
    equal to the single-chip sparse engine."""
    from vstrains_tpu.ops.pe_infer import PESparseResult

    rng = np.random.RandomState(61)
    k = 11
    refs = _random_refs(rng, 4, [80, 100, 120, 140])
    fwd, rve = _sample_reads(rng, refs, 64, 30, k)
    batch = _make_batch(fwd, rve, k + 1)
    ids = [str(i) for i in range(4)]
    mesh = make_mesh(data=8, model=1, devices=eight_devices)
    res = infer_pe_links_sharded(ids, refs, batch, k, mesh,
                                 batch_size=48, stats_mode="sparse")
    assert isinstance(res, PESparseResult)
    serial = infer_pe_links(ids, refs, batch, k, batch_size=32,
                            stats_mode="sparse")
    _assert_sparse_equal(serial, res)


def test_sp_window_hashes_match_host(eight_devices):
    rng = np.random.RandomState(5)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    s = bases[rng.randint(0, 4, 1000)].tobytes().decode()
    codes = encode_seq(s)
    L = 22
    mesh = make_mesh(data=8, model=1, devices=eight_devices)
    h1, h2, valid = sp_window_hashes(codes, L, mesh)
    e1, e2, ev = window_hashes_np(codes, L)
    np.testing.assert_array_equal(valid, ev)
    np.testing.assert_array_equal(h1, e1)
    np.testing.assert_array_equal(h2, e2)


def test_multihost_degrades_to_sharded(eight_devices):
    """Single-process multihost path == plain sharded path."""
    from vstrains_tpu.parallel.distributed import (host_read_stripe,
                                                   infer_pe_links_multihost)
    rng = np.random.RandomState(23)
    k = 11
    refs = _random_refs(rng, 4, [70, 90, 110, 130])
    fwd, rve = _sample_reads(rng, refs, 64, 35, k)
    batch = _make_batch(fwd, rve, k + 1)
    ids = [str(i) for i in range(4)]
    serial = infer_pe_links(ids, refs, batch, k, batch_size=32)
    multi = infer_pe_links_multihost(ids, refs, batch, k, model=2,
                                     batch_size=32)
    np.testing.assert_array_equal(serial.node_mat, multi.node_mat)
    np.testing.assert_array_equal(serial.short_mat, multi.short_mat)


def test_host_read_stripe_partition(tmp_path):
    from vstrains_tpu.parallel.distributed import host_read_stripe
    fq1 = tmp_path / "r1.fq"
    fq2 = tmp_path / "r2.fq"
    with open(fq1, "w") as a, open(fq2, "w") as b:
        for i in range(10):
            a.write(f"@r{i}\nACGTACGTACGT\n+\nIIIIIIIIIIII\n")
            b.write(f"@r{i}\nTGCATGCATGCA\n+\nIIIIIIIIIIII\n")
    stripes = [host_read_stripe(str(fq1), str(fq2), 6, pid, 3)
               for pid in range(3)]
    assert [s.num_pairs for s in stripes] == [4, 4, 2]


def test_build_kmer_table_sp_equals_host(eight_devices):
    """Production table build through the SP halo kernel (long nodes
    sharded over the mesh) is bit-identical to the host build."""
    from vstrains_tpu.ops.pe_infer import build_kmer_table

    rng = np.random.RandomState(17)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    seqs = [bases[rng.randint(0, 4, n)].tobytes().decode()
            for n in (9000, 12000, 300)]  # two long, one short
    mesh = make_mesh(data=8, model=1, devices=eight_devices)
    host = build_kmer_table(seqs, 56)
    sp = build_kmer_table(seqs, 56, sp=(mesh, 8192))
    np.testing.assert_array_equal(host.h1_biased, sp.h1_biased)
    np.testing.assert_array_equal(host.h2, sp.h2)
    np.testing.assert_array_equal(host.node, sp.node)
    np.testing.assert_array_equal(host.offset, sp.offset)
    assert host.max_dup == sp.max_dup
    assert host.scan_depth == sp.scan_depth


@pytest.mark.slow
def test_two_process_distributed_matches_serial(tmp_path):
    """Two real jax.distributed processes over localhost: striped read
    loading + global merge must equal the single-process engine
    (parallel/distributed.py's multi-host claim, exercised as actual
    multi-controller processes rather than the single-process
    degradation)."""
    import os
    import socket
    import subprocess
    import sys as _sys

    from vstrains_tpu.core.fastq import load_read_pairs
    from vstrains_tpu.evals.synth import make_dataset
    from vstrains_tpu.ops.pe_infer import infer_pe_links

    ds = make_dataset(str(tmp_path / "data"), num_strains=2,
                      num_bubbles=2, pairs_per_strain=150, seed=41)
    data_dir = str(tmp_path / "data")

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coord = f"127.0.0.1:{port}"
    out_npz = str(tmp_path / "merged.npz")
    worker = os.path.join(os.path.dirname(__file__), "dist_worker.py")
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    procs = [subprocess.Popen(
        [_sys.executable, worker, coord, "2", str(pid), data_dir,
         out_npz], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for pid in (0, 1)]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=300)
        outs.append(out.decode(errors="replace"))
    assert all(p.returncode == 0 for p in procs), "\n".join(outs)

    merged = np.load(out_npz)
    reads = load_read_pairs(ds.fwd_path, ds.rve_path, 22)
    index2id, index2seq = [], []
    with open(ds.gfa_path) as fh:
        for line in fh:
            fields = line.rstrip("\n").split("\t")
            if fields and fields[0] == "S":
                index2id.append(fields[1])
                index2seq.append(fields[2])
    serial = infer_pe_links(index2id, index2seq, reads, 21,
                            batch_size=256)
    np.testing.assert_array_equal(merged["node_mat"], serial.node_mat)
    np.testing.assert_array_equal(merged["short_mat"], serial.short_mat)
    # the sparse COO engine's two-process cross-host merge must also equal the
    # single-process sparse run
    ssing = infer_pe_links(index2id, index2seq, reads, 21,
                           batch_size=256, stats_mode="sparse")
    np.testing.assert_array_equal(merged["pair_keys"], ssing.pair_keys)
    np.testing.assert_array_equal(merged["pair_counts"],
                                  ssing.pair_counts)
    np.testing.assert_array_equal(merged["short_keys"],
                                  ssing.short_keys)
    np.testing.assert_array_equal(merged["short_counts"],
                                  ssing.short_counts)


def test_sparse_multihost_degrades_to_sharded(eight_devices):
    """Single-process infer_pe_links_sparse_multihost == the sharded
    sparse engine == single-chip sparse."""
    from vstrains_tpu.parallel.distributed import \
        infer_pe_links_sparse_multihost

    rng = np.random.RandomState(67)
    k = 11
    refs = _random_refs(rng, 5, [70, 90, 110, 130, 150])
    fwd, rve = _sample_reads(rng, refs, 80, 35, k)
    batch = _make_batch(fwd, rve, k + 1)
    ids = [str(i) for i in range(5)]
    serial = infer_pe_links(ids, refs, batch, k, batch_size=32,
                            stats_mode="sparse")
    multi = infer_pe_links_sparse_multihost(ids, refs, batch, k,
                                            model=2, batch_size=32)
    _assert_sparse_equal(serial, multi)
