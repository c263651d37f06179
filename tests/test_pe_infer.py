"""Device PE-link inference vs the pure-Python oracle: matrices must match
exactly (integer accumulation is order-independent)."""

import numpy as np
import pytest

from tests.oracle_pe import oracle_pe_matrices
from vstrains_tpu.core.fastq import ReadPairBatch, load_read_pairs
from vstrains_tpu.core.seq import revcomp_str
from vstrains_tpu.ops.pe_infer import (build_kmer_table, infer_pe_links,
                                       pe_info_from_result)


def _make_batch(fwd_seqs, rve_seqs, split_len):
    """Build a ReadPairBatch from string reads (mirrors fastq loading)."""
    from vstrains_tpu.core.fastq import _pack
    n_reads = short = 0
    kf, kr = [], []
    for f, r in zip(fwd_seqs, rve_seqs):
        if "N" in f or "N" in r:
            n_reads += 1
        elif len(f) < split_len or len(r) < split_len:
            short += 1
        else:
            kf.append(f.encode())
            kr.append(r.encode())
    fc, fl = _pack(kf)
    rc, rl = _pack(kr)
    return ReadPairBatch(fc, fl, rc, rl, n_reads, short, len(kf))


def _random_refs(rng, n_nodes, lens):
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    return [bases[rng.randint(0, 4, ln)].tobytes().decode()
            for ln in lens]


def _sample_reads(rng, refs, n_pairs, read_len, k):
    """Reads sampled from nodes (both strands) + some random junk."""
    fwd, rve = [], []
    for _ in range(n_pairs):
        which = rng.randint(0, len(refs))
        ref = refs[which]
        if len(ref) <= read_len:
            f = ref
        else:
            p = rng.randint(0, len(ref) - read_len)
            f = ref[p: p + read_len]
        which2 = rng.randint(0, len(refs))
        ref2 = refs[which2]
        if len(ref2) <= read_len:
            r = ref2
        else:
            p2 = rng.randint(0, len(ref2) - read_len)
            r = ref2[p2: p2 + read_len]
        if rng.rand() < 0.3:
            f = revcomp_str(f)
        if rng.rand() < 0.3:
            r = revcomp_str(r)
        if rng.rand() < 0.05:
            f = f[:5] + "N" + f[6:]
        fwd.append(f)
        rve.append(r)
    return fwd, rve


@pytest.mark.parametrize("seed,k", [(0, 11), (1, 15), (2, 21)])
def test_pe_matrices_match_oracle(seed, k):
    rng = np.random.RandomState(seed)
    n_nodes = 6
    lens = rng.randint(k + 5, 200, size=n_nodes)
    refs = _random_refs(rng, n_nodes, lens)
    # make two nodes share a region (duplicate k-mers across nodes)
    refs[1] = refs[0][:40] + refs[1][40:] if len(refs[1]) > 40 else refs[1]
    fwd, rve = _sample_reads(rng, refs, 120, 40, k)

    node_o, short_o, n_o, s_o, u_o = oracle_pe_matrices(refs, fwd, rve, k)

    batch = _make_batch(fwd, rve, k + 1)
    assert batch.n_reads == n_o and batch.short_reads == s_o
    assert batch.used_reads == u_o

    ids = [str(i) for i in range(n_nodes)]
    res = infer_pe_links(ids, refs, batch, k, batch_size=32)
    np.testing.assert_array_equal(res.node_mat, node_o)
    np.testing.assert_array_equal(res.short_mat, short_o)


def test_pe_batch_size_invariance():
    """Integer accumulation must be identical for any batch split."""
    rng = np.random.RandomState(7)
    k = 13
    refs = _random_refs(rng, 4, [80, 90, 100, 110])
    fwd, rve = _sample_reads(rng, refs, 60, 30, k)
    batch = _make_batch(fwd, rve, k + 1)
    ids = [str(i) for i in range(4)]
    r1 = infer_pe_links(ids, refs, batch, k, batch_size=7)
    r2 = infer_pe_links(ids, refs, batch, k, batch_size=64)
    np.testing.assert_array_equal(r1.node_mat, r2.node_mat)
    np.testing.assert_array_equal(r1.short_mat, r2.short_mat)


def test_pe_info_from_result_symmetry():
    rng = np.random.RandomState(3)
    k = 11
    refs = _random_refs(rng, 3, [60, 70, 80])
    fwd, rve = _sample_reads(rng, refs, 40, 30, k)
    batch = _make_batch(fwd, rve, k + 1)
    ids = ["a", "b", "c"]
    res = infer_pe_links(ids, refs, batch, k)
    pe_info, dcpy = pe_info_from_result(ids, res)
    total = res.node_mat + res.short_mat
    for i, u in enumerate(ids):
        for j, v in enumerate(ids):
            key = (min(u, v), max(u, v))
            if i == j:
                assert pe_info[key] == total[i][i]
            elif i < j:
                assert pe_info[key] == total[i][j] + total[j][i]
    assert dcpy == pe_info and dcpy is not pe_info


def test_kmer_table_batched_build_matches_per_node():
    """The batched (sentinel-separated concatenation) table build equals
    a straightforward per-node construction — including nodes with
    embedded N/lowercase bases, nodes shorter than the window, and
    sequences that would collide across the node boundary if the
    separator failed."""
    from vstrains_tpu.core.seq import revcomp_codes, window_hashes_np
    from vstrains_tpu.core.seq import encode_seq

    rng = np.random.RandomState(23)
    L = 8
    seqs = _random_refs(rng, 12, [30, 7, 40, 15, 8, 25, 60, 9, 33,
                                  12, 50, 14])
    # same suffix/prefix across adjacent nodes: boundary windows would
    # match if separator windows slipped through
    seqs[2] = seqs[0][-6:] + seqs[2]
    seqs[3] = seqs[3][:10] + "N" + seqs[3][11:]
    seqs[5] = seqs[5][:4] + "acgt" + seqs[5][8:]  # lowercase -> bad codes

    table = build_kmer_table(seqs, L)

    exp = []
    for i, s in enumerate(seqs):
        n = len(s)
        if n < L:
            continue
        codes = encode_seq(s)
        for cc, is_rc in ((codes, False), (revcomp_codes(codes), True)):
            h1, h2, v = window_hashes_np(cc, L)
            for j in np.nonzero(v)[0]:
                off = (n - L - j) if is_rc else j
                exp.append((int(h1[j]), int(h2[j]), i, int(off)))
    exp.sort()
    m = table.num_entries
    assert m == len(exp)
    got = list(zip(
        (table.h1_biased[:m].view(np.uint32) ^ np.uint32(0x80000000))
        .tolist(),
        table.h2[:m].view(np.uint32).tolist(),
        table.node[:m].tolist(), table.offset[:m].tolist()))
    assert got == exp


def test_kmer_table_palindrome_double_entry():
    """A palindromic k-mer inserts both strand entries (reference inserts
    kmer and rev_kmer separately even when equal)."""
    # split_len=4; "ACGT" is its own revcomp
    table = build_kmer_table(["ACGT"], 4)
    assert table.num_entries == 2
    m = table.num_entries
    assert table.node[:m].tolist() == [0, 0]
    assert table.offset[:m].tolist() == [0, 0]
    # arrays bucket-pad with never-matching sentinels
    assert table.h1_biased.shape[0] >= 1024
    assert (table.h1_biased[m:] == 2**31 - 1).all()


def test_process_pe_info_files_match_inmemory(tmp_path):
    """File round-trip (reference loader contract) == in-memory path."""
    from vstrains_tpu.ops.pe_infer import process_pe_info, write_pe_files
    rng = np.random.RandomState(9)
    k = 11
    refs = _random_refs(rng, 3, [60, 70, 80])
    fwd, rve = _sample_reads(rng, refs, 40, 30, k)
    batch = _make_batch(fwd, rve, k + 1)
    ids = ["a", "b", "c"]
    res = infer_pe_links(ids, refs, batch, k)
    write_pe_files(res, str(tmp_path / "pe_info"), str(tmp_path / "st_info"))
    mem, mem_d = pe_info_from_result(ids, res)
    filed, filed_d = process_pe_info(ids, str(tmp_path / "pe_info"),
                                     str(tmp_path / "st_info"))
    assert mem == filed and mem_d == filed_d


def test_sparse_pe_info_matches_dense():
    from vstrains_tpu.ops.pe_infer import pe_info_sparse_from_result
    rng = np.random.RandomState(13)
    k = 11
    refs = _random_refs(rng, 4, [60, 70, 80, 90])
    fwd, rve = _sample_reads(rng, refs, 50, 30, k)
    batch = _make_batch(fwd, rve, k + 1)
    ids = ["n0", "n1", "n2", "n3"]
    res = infer_pe_links(ids, refs, batch, k)
    dense, dense_d = pe_info_from_result(ids, res)
    sparse, sparse_d = pe_info_sparse_from_result(ids, res)
    for key, val in dense.items():
        assert sparse[key] == val  # missing sparse keys read as 0
        assert sparse_d[key] == val
    for key in sparse:
        assert dense[key] == sparse[key]


def test_iupac_read_characters_never_match():
    """Reads containing non-ACGT non-'N' characters (IUPAC codes, CR from
    CRLF files) pass the loader's N-filter but their windows must never
    hash-match — regression for the device validity mask."""
    refs = ["ACGTACGTACGTACGTACGTACGT"]
    k = 7
    good = refs[0][:16]
    bad = good[:5] + "R" + good[6:]  # one IUPAC base
    node_o, short_o, *_ = oracle_pe_matrices(refs, [bad], [bad], k)
    batch = _make_batch([bad], [bad], k + 1)
    assert batch.used_reads == 1  # 'R' is not 'N': pair kept
    res = infer_pe_links(["x"], refs, batch, k, batch_size=4)
    np.testing.assert_array_equal(res.node_mat, node_o)
    np.testing.assert_array_equal(res.short_mat, short_o)
    # and a clean read still matches
    res2 = infer_pe_links(["x"], refs, _make_batch([good], [good], k + 1),
                          k, batch_size=4)
    assert res2.node_mat.sum() > 0


def test_probe_modes_agree():
    """The legacy searchsorted probe (cross-check implementation) and the
    sort-merge-join default produce identical matrices."""
    rng = np.random.RandomState(31)
    k = 13
    refs = _random_refs(rng, 5, [70, 90, 110, 130, 150])
    fwd, rve = _sample_reads(rng, refs, 60, 35, k)
    batch = _make_batch(fwd, rve, k + 1)
    ids = [str(i) for i in range(5)]
    a = infer_pe_links(ids, refs, batch, k, batch_size=32,
                       probe_mode="sort")
    b = infer_pe_links(ids, refs, batch, k, batch_size=32,
                       probe_mode="searchsorted")
    np.testing.assert_array_equal(a.node_mat, b.node_mat)
    np.testing.assert_array_equal(a.short_mat, b.short_mat)


def test_probe_lookup_agrees():
    """The direct-address lookup probe (default) equals the sort-join."""
    rng = np.random.RandomState(77)
    k = 13
    refs = _random_refs(rng, 6, [80, 90, 100, 120, 140, 160])
    fwd, rve = _sample_reads(rng, refs, 80, 35, k)
    batch = _make_batch(fwd, rve, k + 1)
    ids = [str(i) for i in range(6)]
    a = infer_pe_links(ids, refs, batch, k, batch_size=32,
                       probe_mode="lookup")
    b = infer_pe_links(ids, refs, batch, k, batch_size=32,
                       probe_mode="sort")
    np.testing.assert_array_equal(a.node_mat, b.node_mat)
    np.testing.assert_array_equal(a.short_mat, b.short_mat)


def _coo_to_dense(keys, counts, n):
    out = np.zeros((n, n), dtype=np.int64)
    out[keys // n, keys % n] = counts
    return out


def test_sparse_stats_mode_matches_dense():
    """The large-N sparse stats path (COO output) must reproduce the dense
    matrices exactly, including same-end triangular counts and file
    bytes."""
    import os
    import tempfile

    from vstrains_tpu.ops.pe_infer import (pe_info_sparse_from_result,
                                           write_pe_files)

    rng = np.random.RandomState(5)
    k = 13
    n = 7
    refs = _random_refs(rng, n, [80, 95, 100, 120, 140, 150, 170])
    fwd, rve = _sample_reads(rng, refs, 120, 35, k)
    batch = _make_batch(fwd, rve, k + 1)
    ids = [f"n{i}" for i in range(n)]
    dense = infer_pe_links(ids, refs, batch, k, batch_size=32,
                           stats_mode="dense")
    sparse = infer_pe_links(ids, refs, batch, k, batch_size=32,
                            stats_mode="sparse")
    np.testing.assert_array_equal(
        _coo_to_dense(sparse.pair_keys, sparse.pair_counts, n),
        dense.node_mat)
    np.testing.assert_array_equal(
        _coo_to_dense(sparse.short_keys, sparse.short_counts, n),
        dense.short_mat)

    pe_d, _ = pe_info_sparse_from_result(ids, dense)
    pe_s, _ = pe_info_sparse_from_result(ids, sparse)
    assert dict(pe_d.items()) == dict(pe_s.items())

    with tempfile.TemporaryDirectory() as td:
        write_pe_files(dense, f"{td}/pe_d", f"{td}/st_d")
        write_pe_files(sparse, f"{td}/pe_s", f"{td}/st_s")
        assert (open(f"{td}/pe_d", "rb").read()
                == open(f"{td}/pe_s", "rb").read())
        assert (open(f"{td}/st_d", "rb").read()
                == open(f"{td}/st_s", "rb").read())


def test_sparse_cap_overflow_retry(caplog):
    """A read saturating more nodes than the starting cap triggers the
    enlarge-and-retry path and still produces exact results."""
    import logging

    from vstrains_tpu.ops import pe_infer as P

    rng = np.random.RandomState(9)
    k = 13
    # 20 identical nodes: every matching read saturates all of them
    seq = _random_refs(rng, 1, [90])[0]
    refs = [seq] * 20
    read = seq[10:45]
    batch = _make_batch([read] * 8, [read] * 8, k + 1)
    ids = [str(i) for i in range(20)]
    dense = infer_pe_links(ids, refs, batch, k, batch_size=8,
                           stats_mode="dense")
    with caplog.at_level(logging.INFO, logger="vstrains_tpu.ops.pe_infer"):
        sparse = infer_pe_links(ids, refs, batch, k, batch_size=8,
                                stats_mode="sparse")
    assert isinstance(sparse, P.PESparseResult)
    assert any("overflowed" in r.message for r in caplog.records)
    np.testing.assert_array_equal(
        _coo_to_dense(sparse.pair_keys, sparse.pair_counts, 20),
        dense.node_mat)


def test_stats_impls_agree():
    """Both stats accumulators — scatter and one-hot — produce identical
    saturation masks, at duplicate depths above 1."""
    import jax.numpy as jnp

    from vstrains_tpu.ops import pe_infer as P

    rng = np.random.RandomState(5)
    k = 11
    # repeated motifs force max_dup > 1
    motif = _random_refs(rng, 1, [40])[0]
    refs = [motif + _random_refs(rng, 1, [60])[0] for _ in range(4)]
    fwd, rve = _sample_reads(rng, refs, 48, 30, k)
    split_len = k + 1
    batch = _make_batch(fwd, rve, split_len)
    table = build_kmer_table(refs, split_len)
    assert table.max_dup > 1
    N = table.num_nodes

    tab_h1 = jnp.asarray(table.h1_biased)
    tab_h2 = jnp.asarray(table.h2)
    tab_node = jnp.asarray(table.node)
    seq_lens = jnp.asarray(table.seq_lens)
    codes, lens = P._stack_ends(
        jnp.asarray(batch.fwd_codes), jnp.asarray(batch.fwd_len),
        jnp.asarray(batch.rve_codes), jnp.asarray(batch.rve_len))
    q1, h2qi, valid, lo = P._hash_join_kernel(codes, lens, tab_h1,
                                              split_len=split_len)

    base = P._stats_saturate_kernel(
        q1, h2qi, valid, lo, lens, tab_h1, tab_h2, tab_node, seq_lens,
        split_len=split_len, max_dup=table.max_dup, num_nodes=N,
        stats_impl="scatter")
    onehot = P._stats_saturate_kernel(
        q1, h2qi, valid, lo, lens, tab_h1, tab_h2, tab_node, seq_lens,
        split_len=split_len, max_dup=table.max_dup, num_nodes=N,
        stats_impl="onehot")
    np.testing.assert_array_equal(np.asarray(base), np.asarray(onehot))


def test_sortfill_probe_matches_classic_at_depth():
    """The gather-free payload-sort probe ("sort" auto-upgrade) equals
    the classic sort-join ("sortjoin") on a graph with duplicate k-mer
    runs (max_dup > 1), which exercises the pre-shifted payload chain."""
    rng = np.random.RandomState(11)
    k = 11
    motif = _random_refs(rng, 1, [45])[0]
    refs = [motif + _random_refs(rng, 1, [55])[0] for _ in range(5)]
    fwd, rve = _sample_reads(rng, refs, 64, 30, k)
    batch = _make_batch(fwd, rve, k + 1)
    table = build_kmer_table(refs, k + 1)
    assert 1 < table.max_dup <= 6
    ids = [str(i) for i in range(5)]
    a = infer_pe_links(ids, refs, batch, k, batch_size=32,
                       probe_mode="sort")      # -> sortfill
    b = infer_pe_links(ids, refs, batch, k, batch_size=32,
                       probe_mode="sortjoin")  # classic join + gathers
    np.testing.assert_array_equal(a.node_mat, b.node_mat)
    np.testing.assert_array_equal(a.short_mat, b.short_mat)


def test_dense_sortfill_mid_n_deep_dup_matches_oracle():
    """The mid-N dense path (512 < N <= 4096 with max_dup in 7..16 —
    the realistic-bench shape that used to fall back to classic join +
    scatter stats) rides sortfill with wide node ids and matches both
    the reference-loop oracle and the classic cross-check probe."""
    import vstrains_tpu.ops.pe_infer as P
    rng = np.random.RandomState(17)
    k = 11
    motif = _random_refs(rng, 1, [30])[0]
    # 9 nodes share a motif (max_dup ~ 9); the rest are unique
    refs = ([motif + _random_refs(rng, 1, [40])[0] for _ in range(9)]
            + _random_refs(rng, 531, [60] * 531))
    n = len(refs)
    table = build_kmer_table(refs, k + 1)
    assert 6 < table.max_dup <= 16
    assert P._sortfill_node_bits(n) == 10
    fwd, rve = _sample_reads(rng, refs, 80, 30, k)
    batch = _make_batch(fwd, rve, k + 1)
    ids = [str(i) for i in range(n)]
    a = infer_pe_links(ids, refs, batch, k, batch_size=64,
                       stats_mode="dense")    # sortfill, wide node ids
    b = infer_pe_links(ids, refs, batch, k, batch_size=64,
                       stats_mode="dense", probe_mode="sortjoin")
    np.testing.assert_array_equal(a.node_mat, b.node_mat)
    np.testing.assert_array_equal(a.short_mat, b.short_mat)
    nm, sm, *_ = oracle_pe_matrices(refs, fwd, rve, k)
    np.testing.assert_array_equal(a.node_mat, nm)
    np.testing.assert_array_equal(a.short_mat, sm)


def test_heavy_repeat_graph_beyond_sortfill_packing():
    """A graph whose duplicate runs exceed the sortfill payload cap
    (max_dup > 16) auto-falls back to the classic join and still matches
    the reference-loop oracle exactly."""
    import vstrains_tpu.ops.pe_infer as P
    rng = np.random.RandomState(41)
    k = 11
    motif = _random_refs(rng, 1, [30])[0]
    # 24 nodes share one motif -> duplicate runs of ~24 > cap
    refs = [motif + _random_refs(rng, 1, [50])[0] for _ in range(24)]
    table = build_kmer_table(refs, k + 1)
    assert table.max_dup > P._SORTFILL_MAX_DUP
    fwd, rve = _sample_reads(rng, refs, 80, 30, k)
    batch = _make_batch(fwd, rve, k + 1)
    ids = [str(i) for i in range(len(refs))]
    res = infer_pe_links(ids, refs, batch, k, batch_size=64)
    nm, sm, *_ = oracle_pe_matrices(refs, fwd, rve, k)
    np.testing.assert_array_equal(res.node_mat, nm)
    np.testing.assert_array_equal(res.short_mat, sm)


def test_sortfill_stride_bit_identity():
    """The strided-anchor fill (only every S-th table key rides the
    sort; the run start is recovered by the block gather + compare) is
    bit-identical to stride=1 for every stride, including strides that
    do not divide the table size and runs crossing block boundaries."""
    import jax.numpy as jnp

    import vstrains_tpu.ops.pe_infer as P
    rng = np.random.RandomState(17)
    k = 11
    # shared motifs force multi-entry runs at arbitrary block offsets
    motif = _random_refs(rng, 1, [40])[0]
    refs = [motif + _random_refs(rng, 1, [60])[0] for _ in range(7)]
    refs += _random_refs(rng, 5, [80, 90, 100, 110, 120])
    table = build_kmer_table(refs, k + 1)
    assert table.num_entries % 4 != 0 or True  # any M is fine
    node_bits = P._sortfill_node_bits(len(refs))
    pays = jnp.asarray(P._build_sortfill_payloads(table, node_bits))
    fwd, rve = _sample_reads(rng, refs, 100, 30, k)
    batch = _make_batch(fwd, rve, k + 1)
    from vstrains_tpu.core.fastq import _pack  # noqa: F401
    codes = np.concatenate([batch.fwd_codes, batch.rve_codes])
    lens = np.concatenate([batch.fwd_len, batch.rve_len])
    th1 = jnp.asarray(table.h1_biased)
    base = np.asarray(P._sortfill_node_slots(
        jnp.asarray(codes), jnp.asarray(lens), th1, pays, k + 1,
        len(refs), node_bits=node_bits, stride=1))
    for s in (2, 3, 4, 7, 16):
        got = np.asarray(P._sortfill_node_slots(
            jnp.asarray(codes), jnp.asarray(lens), th1, pays, k + 1,
            len(refs), node_bits=node_bits, stride=s))
        np.testing.assert_array_equal(got, base)


def test_sortfill_stride_e2e_matches_oracle(monkeypatch):
    """Full inference with the stride forced on (small tables would not
    trigger it) matches the reference-loop oracle exactly, dense and
    sparse drivers both."""
    monkeypatch.setenv("VSTRAINS_SORTFILL_STRIDE", "4")
    rng = np.random.RandomState(29)
    k = 11
    refs = _random_refs(rng, 8, [150, 200, 250, 150, 200, 250, 180, 220])
    refs[1] = refs[0][:50] + refs[1][50:]
    fwd, rve = _sample_reads(rng, refs, 300, 40, k)
    batch = _make_batch(fwd, rve, k + 1)
    ids = [str(i) for i in range(len(refs))]
    nm, sm, *_ = oracle_pe_matrices(refs, fwd, rve, k)
    dense = infer_pe_links(ids, refs, batch, k, batch_size=128)
    np.testing.assert_array_equal(dense.node_mat, nm)
    np.testing.assert_array_equal(dense.short_mat, sm)
    sp = infer_pe_links(ids, refs, batch, k, batch_size=128,
                        stats_mode="sparse")
    from vstrains_tpu.ops.pe_infer import PESparseResult
    assert isinstance(sp, PESparseResult)
    dm = np.zeros_like(nm)
    dm[sp.pair_keys // len(refs), sp.pair_keys % len(refs)] = \
        sp.pair_counts
    np.testing.assert_array_equal(dm, nm)


def test_explicit_sortfill_beyond_packing_falls_back():
    """probe_mode='sortfill' requested EXPLICITLY on a graph beyond the
    payload packing cap (max_dup > 16) must apply the same guards as the
    auto-upgrade path — previously it truncated duplicate ranks and
    returned silently wrong matrices (advisor finding, round 2)."""
    import vstrains_tpu.ops.pe_infer as P
    rng = np.random.RandomState(41)
    k = 11
    motif = _random_refs(rng, 1, [30])[0]
    refs = [motif + _random_refs(rng, 1, [50])[0] for _ in range(24)]
    table = build_kmer_table(refs, k + 1)
    assert table.max_dup > P._SORTFILL_MAX_DUP
    fwd, rve = _sample_reads(rng, refs, 80, 30, k)
    batch = _make_batch(fwd, rve, k + 1)
    ids = [str(i) for i in range(len(refs))]
    res = infer_pe_links(ids, refs, batch, k, batch_size=64,
                         probe_mode="sortfill")
    nm, sm, *_ = oracle_pe_matrices(refs, fwd, rve, k)
    np.testing.assert_array_equal(res.node_mat, nm)
    np.testing.assert_array_equal(res.short_mat, sm)


def test_length_buckets_plan():
    from vstrains_tpu.ops.pe_infer import _length_buckets
    rng = np.random.RandomState(5)
    n = 1024
    # 85% short (100bp), 12% medium (200bp), 3% rare long (290bp)
    lens = rng.choice([100, 200, 290], size=n, p=[0.85, 0.12, 0.03])
    T = 320
    fc = np.zeros((n, T), np.uint8)
    fl = lens.astype(np.int32)
    batch = type("B", (), dict(num_pairs=n, fwd_codes=fc, fwd_len=fl,
                               rve_codes=fc, rve_len=fl))()
    plan = _length_buckets(batch, 22, batch_size=128)
    widths = [w for w, _ in plan]
    # rare 290bp merges into the widest bucket; the widest survives
    assert widths == [320, 224, 128]
    assert sum(len(ix) for _, ix in plan) == n
    # uniform widths -> no plan
    batch.fwd_len = batch.rve_len = np.full(n, 100, np.int32)
    batch.fwd_codes = batch.rve_codes = fc[:, :128]
    assert _length_buckets(batch, 22, batch_size=128) is None


def test_bucketed_matches_unbucketed_mixed_lengths():
    """Mixed-length library: the width-bucketed feed (active at
    batch_size=128 with 1200 pairs) must produce the exact matrices of
    the single-width feed (bucketing disabled by the 4x-batch gate)."""
    rng = np.random.RandomState(23)
    k = 11
    refs = _random_refs(rng, 6, [300, 350, 400, 300, 350, 400])
    short_f, short_r = _sample_reads(rng, refs, 900, 40, k)
    long_f, long_r = _sample_reads(rng, refs, 300, 120, k)
    fwd, rve = short_f + long_f, short_r + long_r
    batch = _make_batch(fwd, rve, k + 1)
    ids = [str(i) for i in range(len(refs))]
    a = infer_pe_links(ids, refs, batch, k, batch_size=128)
    b = infer_pe_links(ids, refs, batch, k, batch_size=4096)
    np.testing.assert_array_equal(a.node_mat, b.node_mat)
    np.testing.assert_array_equal(a.short_mat, b.short_mat)


def test_sortfill_fill_impls_agree():
    """The scan fill and the cummin fill (rev-cummin over ascending
    table rows + per-rank gathers) produce identical slot tensors."""
    import jax.numpy as jnp
    import vstrains_tpu.ops.pe_infer as P
    rng = np.random.RandomState(3)
    k = 11
    motif = _random_refs(rng, 1, [40])[0]
    refs = [motif + _random_refs(rng, 1, [60])[0] for _ in range(4)]
    fwd, rve = _sample_reads(rng, refs, 48, 34, k)
    batch = _make_batch(fwd, rve, k + 1)
    table = build_kmer_table(refs, k + 1)
    assert table.max_dup > 1
    pays = jnp.asarray(P._build_sortfill_payloads(table))
    codes, lens = P._stack_ends(
        jnp.asarray(batch.fwd_codes), jnp.asarray(batch.fwd_len),
        jnp.asarray(batch.rve_codes), jnp.asarray(batch.rve_len))
    a = P._sortfill_node_slots(codes, lens, jnp.asarray(table.h1_biased),
                               pays, k + 1, len(refs), fill="scan")
    b = P._sortfill_node_slots(codes, lens, jnp.asarray(table.h1_biased),
                               pays, k + 1, len(refs), fill="cummin")
    hits = int((np.asarray(a) < len(refs)).sum())
    assert hits > 0, "no matches exercised"
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_sortfill_node_bits_gate():
    from vstrains_tpu.ops.pe_infer import _sortfill_node_bits
    assert _sortfill_node_bits(1) == 9
    assert _sortfill_node_bits(512) == 9
    assert _sortfill_node_bits(513) == 10
    assert _sortfill_node_bits(1 << 18) == 18
    assert _sortfill_node_bits((1 << 18) + 1) is None


def test_sparse_sortfill_adaptive_node_bits():
    """Beyond 512 nodes the sparse sortfill probe packs wider node ids
    (narrower h2 check); its COO output must equal the classic join's."""
    rng = np.random.RandomState(11)
    k = 13
    n = 600  # node_bits = 10
    refs = _random_refs(rng, n, [60] * n)
    fwd, rve = _sample_reads(rng, refs, 240, 30, k)
    batch = _make_batch(fwd, rve, k + 1)
    ids = [str(i) for i in range(n)]
    a = infer_pe_links(ids, refs, batch, k, batch_size=128,
                       stats_mode="sparse")
    b = infer_pe_links(ids, refs, batch, k, batch_size=128,
                       stats_mode="sparse", probe_mode="sortjoin")
    np.testing.assert_array_equal(a.pair_keys, b.pair_keys)
    np.testing.assert_array_equal(a.pair_counts, b.pair_counts)
    np.testing.assert_array_equal(a.short_keys, b.short_keys)
    np.testing.assert_array_equal(a.short_counts, b.short_counts)


def test_sparse_sortfill_matches_oracle_small():
    """Sparse sortfill vs the reference-loop oracle on a small graph
    with duplicate k-mers (multi-rank payloads exercised)."""
    rng = np.random.RandomState(21)
    k = 11
    motif = _random_refs(rng, 1, [30])[0]
    refs = [motif + s for s in _random_refs(rng, 5, [50] * 5)]
    fwd, rve = _sample_reads(rng, refs, 64, 28, k)
    batch = _make_batch(fwd, rve, k + 1)
    table = build_kmer_table(refs, k + 1)
    assert table.max_dup > 1
    ids = [str(i) for i in range(len(refs))]
    sparse = infer_pe_links(ids, refs, batch, k, batch_size=16,
                            stats_mode="sparse")
    nm, sm, *_ = oracle_pe_matrices(refs, fwd, rve, k)
    np.testing.assert_array_equal(
        _coo_to_dense(sparse.pair_keys, sparse.pair_counts, len(refs)),
        nm)
    np.testing.assert_array_equal(
        _coo_to_dense(sparse.short_keys, sparse.short_counts, len(refs)),
        sm)


def test_wire_roundtrip_matches_stack_ends():
    """Wire pack/unpack reproduces the stacked end-batch exactly for
    clean chunks (padding bases differ but are masked by the length
    test; compare within-read content and lengths)."""
    import jax.numpy as jnp
    import vstrains_tpu.ops.pe_infer as P
    rng = np.random.RandomState(7)
    refs = _random_refs(rng, 3, [70, 80, 90])
    fwd, rve = _sample_reads(rng, refs, 33, 29, 11)
    batch = _make_batch(fwd, rve, 12)
    T = max(batch.fwd_codes.shape[1], batch.rve_codes.shape[1])
    wire = P._pack_wire_np(batch.fwd_codes, batch.fwd_len,
                           batch.rve_codes, batch.rve_len, T)
    assert wire.shape[1] == P._wire_width(T)
    codes, lens = P._unpack_wire(jnp.asarray(wire), T)
    codes = np.asarray(codes)
    lens = np.asarray(lens)
    ref_lens = np.concatenate([batch.fwd_len, batch.rve_len])
    np.testing.assert_array_equal(lens, ref_lens)
    ref_codes = np.concatenate([
        np.pad(batch.fwd_codes,
               ((0, 0), (0, T - batch.fwd_codes.shape[1])),
               constant_values=255),
        np.pad(batch.rve_codes,
               ((0, 0), (0, T - batch.rve_codes.shape[1])),
               constant_values=255)])
    for i in range(codes.shape[0]):
        np.testing.assert_array_equal(codes[i, :lens[i]],
                                      ref_codes[i, :lens[i]])


def test_native_wire_pack_matches_numpy():
    """The C++ packer (check fused in) produces byte-identical wire rows
    to _pack_wire_np and flags in-read non-ACGT codes the same way."""
    import vstrains_tpu.ops.pe_infer as P
    from vstrains_tpu.native import get_lib, wire_pack_native
    lib = get_lib()
    if lib is None or not hasattr(lib, "wire_pack"):
        pytest.skip("native library unavailable")
    rng = np.random.RandomState(3)
    for trial in range(10):
        B = int(rng.randint(1, 40))
        tf, tr = (int(x) for x in rng.randint(5, 40, 2))
        T = max(tf, tr)
        fc = rng.randint(0, 4, (B, tf)).astype(np.uint8)
        rc = rng.randint(0, 4, (B, tr)).astype(np.uint8)
        fl = rng.randint(1, tf + 1, B).astype(np.int32)
        rl = rng.randint(1, tr + 1, B).astype(np.int32)
        fc[np.arange(tf)[None, :] >= fl[:, None]] = 255
        rc[np.arange(tr)[None, :] >= rl[:, None]] = 255
        ref = P._pack_wire_np(fc, fl, rc, rl, T)
        got = wire_pack_native(fc, fl, rc, rl, T)
        assert got is not None
        np.testing.assert_array_equal(ref, got)
        bad = fc.copy()
        bad[0, 0] = 4  # IUPAC survivor inside a read -> byte path
        assert wire_pack_native(bad, fl, rc, rl, T) is None


def _run_with_feed_spy(ids, refs, batch, k, **kw):
    import vstrains_tpu.ops.pe_infer as P
    feeds = []
    orig = P._wire_batches

    def spy(reads, bs, force_bytes=False):
        for kind, payload in orig(reads, bs, force_bytes=force_bytes):
            feeds.append(kind)
            yield kind, payload

    P._wire_batches = spy
    try:
        res = infer_pe_links(ids, refs, batch, k, **kw)
    finally:
        P._wire_batches = orig
    return res, feeds


def test_wire_feed_matches_oracle_clean():
    """A clean library rides the compact wire format and matches the
    reference-loop oracle exactly."""
    rng = np.random.RandomState(13)
    refs = _random_refs(rng, 4, [90, 100, 110, 120])
    fwd, rve = _sample_reads(rng, refs, 120, 32, 11)
    batch = _make_batch(fwd, rve, 12)
    ids = [str(i) for i in range(4)]
    res, feeds = _run_with_feed_spy(ids, refs, batch, 11, batch_size=32)
    assert set(feeds) == {"wire"}
    nm, sm, *_ = oracle_pe_matrices(refs, fwd, rve, 11)
    np.testing.assert_array_equal(res.node_mat, nm)
    np.testing.assert_array_equal(res.short_mat, sm)


def test_wire_feed_iupac_falls_back_to_bytes():
    """Reads with IUPAC bases (which pass the loader's N-filter) force
    their batch onto the byte path — fallback is per batch, so clean
    batches keep riding the wire; results still match the oracle, where
    such windows simply never match a table k-mer."""
    rng = np.random.RandomState(13)
    refs = _random_refs(rng, 4, [90, 100, 110, 120])
    fwd, rve = _sample_reads(rng, refs, 120, 32, 11)
    # one IUPAC read in every 32-pair batch -> every batch falls back
    fwd = [("R" + f[1:]) if i % 17 == 0 else f
           for i, f in enumerate(fwd)]
    batch = _make_batch(fwd, rve, 12)
    ids = [str(i) for i in range(4)]
    res, feeds = _run_with_feed_spy(ids, refs, batch, 11, batch_size=32)
    # batches holding an IUPAC read fall back; the rest ride the wire
    assert "bytes" in set(feeds)
    nm, sm, *_ = oracle_pe_matrices(refs, fwd, rve, 11)
    np.testing.assert_array_equal(res.node_mat, nm)
    np.testing.assert_array_equal(res.short_mat, sm)


def test_parallel_table_sort_matches_serial(monkeypatch):
    """The partition-parallel table sort (top-byte radix partition +
    threaded per-partition sorts + tie canonization) must produce the
    byte-identical table the serial stable-sort path builds — including
    max_dup (computed per-partition in the threaded path) and the
    bucket index."""
    import vstrains_tpu.ops.pe_infer as P

    rng = np.random.RandomState(7)
    refs = _random_refs(rng, 60, list(rng.randint(80, 400, 60)))
    # duplicate some sequences so tie runs (equal h1,h2 across distinct
    # node/offset) actually occur
    refs += refs[:10]

    monkeypatch.setattr(P, "_PARALLEL_SORT_MIN", 1 << 60)
    serial = P.build_kmer_table(refs, 12, bucket_index=True)
    monkeypatch.setattr(P, "_PARALLEL_SORT_MIN", 0)
    par = P.build_kmer_table(refs, 12, bucket_index=True)

    for f in ("h1_biased", "h2", "node", "offset", "bucket_starts"):
        np.testing.assert_array_equal(getattr(serial, f), getattr(par, f),
                                      err_msg=f)
    assert serial.max_dup == par.max_dup
    assert serial.scan_depth == par.scan_depth
    assert serial.num_entries == par.num_entries


def test_bucket_index_auto_skip(monkeypatch):
    """bucket_index='auto' skips the direct-address index only for
    metaSPAdes-scale sortfill-eligible tables; the lookup probe then
    falls back to the sort join with identical matrices."""
    import vstrains_tpu.ops.pe_infer as P

    rng = np.random.RandomState(8)
    refs = _random_refs(rng, 6, [90, 100, 110, 120, 130, 140])
    small = P.build_kmer_table(refs, 12)
    assert small.bucket_starts is not None  # under the size threshold

    monkeypatch.setattr(P, "_SORTFILL_STRIDE_MIN_TABLE", 1)
    skipped = P.build_kmer_table(refs, 12)
    assert skipped.bucket_starts is None
    assert skipped.scan_depth == skipped.max_dup
    forced = P.build_kmer_table(refs, 12, bucket_index=True)
    np.testing.assert_array_equal(forced.bucket_starts,
                                  small.bucket_starts)
    # the probe APIs treat a missing index as "use the sort join"
    np.testing.assert_array_equal(skipped.h1_biased, small.h1_biased)


def test_sparse_two_tier_full_pull_matches_dense():
    """Reads saturating more nodes than the always-pulled head
    (_SPARSE_HEAD=4) but within cap force the drain's full-list pull
    tier; results must still match the dense path exactly."""
    rng = np.random.RandomState(11)
    k = 13
    # 8 identical nodes: every matching read saturates all 8 (> head 4,
    # <= starting cap 16, so no enlarge-retry — pure full-pull tier)
    seq = _random_refs(rng, 1, [90])[0]
    refs = [seq] * 8
    read = seq[10:45]
    batch = _make_batch([read] * 12, [read] * 12, k + 1)
    ids = [str(i) for i in range(8)]
    dense = infer_pe_links(ids, refs, batch, k, batch_size=8,
                           stats_mode="dense")
    sparse = infer_pe_links(ids, refs, batch, k, batch_size=8,
                            stats_mode="sparse")
    np.testing.assert_array_equal(
        _coo_to_dense(sparse.pair_keys, sparse.pair_counts, 8),
        dense.node_mat)
    np.testing.assert_array_equal(
        _coo_to_dense(sparse.short_keys, sparse.short_counts, 8),
        dense.short_mat)


@pytest.mark.parametrize("forced", [None, "scatter", "onehot", "bogus"])
@pytest.mark.parametrize("shape", [(100, 95, 1), (773, 195, 4),
                                   (3000, 95, 16)])
def test_stats_impl_choice_ignores_platform(monkeypatch, forced, shape):
    """The stats accumulator is a function of the shape (and the
    VSTRAINS_STATS_IMPL override) alone: it never asks which backend or
    device it runs on."""
    import jax

    import vstrains_tpu.ops.pe_infer as P

    def boom(*a, **k):
        raise AssertionError("_stats_impl_choice read the platform")

    monkeypatch.setattr(jax, "default_backend", boom)
    monkeypatch.setattr(jax, "devices", boom)
    if forced is None:
        monkeypatch.delenv("VSTRAINS_STATS_IMPL", raising=False)
    else:
        monkeypatch.setenv("VSTRAINS_STATS_IMPL", forced)
    got = P._stats_impl_choice(*shape)
    assert got in P.STATS_IMPLS
    if forced in P.STATS_IMPLS:
        assert got == forced


@pytest.mark.parametrize("n_nodes,batch,pairs,backend,sparse", [
    (100, 16384, 1_000_000, "gpu", False),     # bench.py shape
    (773, 16384, 388_928, "gpu", False),       # HIV labmix
    (3000, 16384, 1_000_000, "gpu", False),
    (4000, 16384, 1_000_000, "gpu", True),     # stats planes > budget
    (50_000, 16384, 1_048_576, "gpu", True),   # metaSPAdes 50k
    (2000, 16384, 100_000, "cpu", True),       # CPU: no matrix units
    (2000, 16384, 60_000, "cpu", False),
    (1024, 16384, 1_000_000, "cpu", False),
])
def test_sparse_cutover_by_nodes(n_nodes, batch, pairs, backend, sparse):
    import vstrains_tpu.ops.pe_infer as P
    assert P._sparse_cutover(n_nodes, batch, pairs, backend) is sparse


def test_small_workload_keeps_default_device(monkeypatch):
    """A library of <= 65,536 pairs runs on JAX's default device: the
    engine never redirects jax_default_device to another backend."""
    import jax

    updates = []
    orig = jax.config.update

    def spy(name, value):
        updates.append(name)
        return orig(name, value)

    monkeypatch.setattr(jax.config, "update", spy)
    before = jax.config.jax_default_device
    rng = np.random.RandomState(12)
    k = 11
    refs = _random_refs(rng, 4, [90, 100, 110, 120])
    fwd, rve = _sample_reads(rng, refs, 64, 32, k)
    batch = _make_batch(fwd, rve, k + 1)
    assert batch.num_pairs <= 65536
    infer_pe_links([str(i) for i in range(4)], refs, batch, k,
                   batch_size=32)
    assert jax.config.jax_default_device is before
    assert "jax_default_device" not in updates


def check_pair_matmuls_exact(B, N, all_ones):
    """_pair_matmuls' float32 products equal int64 numpy products."""
    import jax.numpy as jnp

    import vstrains_tpu.ops.pe_infer as P
    rng = np.random.RandomState(B + N)
    if all_ones:
        f = r = np.ones((B, N), np.float32)
    else:
        f = (rng.rand(B, N) < 0.3).astype(np.float32)
        r = (rng.rand(B, N) < 0.3).astype(np.float32)
    nm, sm = P._pair_matmuls_jit(jnp.asarray(f), jnp.asarray(r),
                                 num_nodes=N)
    fi, ri = f.astype(np.int64), r.astype(np.int64)
    np.testing.assert_array_equal(np.asarray(nm), fi.T @ ri)
    np.testing.assert_array_equal(np.asarray(sm),
                                  np.triu(fi.T @ fi + ri.T @ ri))


@pytest.mark.parametrize("n_nodes,all_ones", [(8, True), (40, True),
                                              (40, False)])
def test_pair_matmuls_exact_at_2_14(n_nodes, all_ones):
    """At B = 2^14 with all-ones rows every cell sums to B (or 2B): the
    float32 accumulation stays exact below 2^24."""
    check_pair_matmuls_exact(1 << 14, n_nodes, all_ones)


def test_batch_above_exact_bound_rejected():
    import vstrains_tpu.ops.pe_infer as P
    batch = _make_batch(["ACGTACGTACGTACGT"], ["ACGTACGTACGTACGT"], 12)
    with pytest.raises(ValueError, match="exact"):
        infer_pe_links(["x"], ["ACGTACGTACGTACGTACGT"], batch, 11,
                       batch_size=P.MAX_EXACT_BATCH + 1)
