"""Paired-end link inference — the performance-critical engine.

Device re-design of the reference's hash-table PE inference
(/root/reference/utils/VStrains_PE_Inference.py:16-188, the component its
README calls out as the v1.1 speedup):

  host:   node (k+1)-mers of both strands -> dual 32-bit window hashes ->
          one flat sorted table (hash-sorted; duplicates adjacent).
  device: per read batch (B reads, K windows each), ONE fused dispatch:
            1. rolling window hashes (uint32 x2 lanes) via the
               prefix-sum factorization;
            2. probe: default is "sortfill" — one stable sort of
               [query ++ table] hashes where packed per-duplicate-rank
               payloads (tag | h2-check | node id) ride along, a cummin
               fill propagates each query's matching run, and one
               contiguous row gather fetches all duplicate ranks
               (binary search, direct-address lookup, and the classic
               positional join are kept as cross-check probes; all have
               produced identical matrices on every tested dataset —
               equal up to the documented dual-hash approximation, since
               sortfill verifies 31-node_bits secondary-hash bits where
               the others verify 32; see docs/DIVERGENCES.md #12);
            3. per-(read, node) stats — hit count and min read k-index —
               through the shape-picked accumulator (XLA scatter or
               one-hot; sparse row-sort above the dense/sparse
               cutover). The reference's third stat, the min ref
               coordinate, cancels out of the saturation test — see
               below — so it is never computed on device;
            4. the reference's saturation test, recast in exact integer
               arithmetic (see below);
            5. link accumulation as matrix products: the reference's
               O(|lefts| x |rights|) Python pair loops are exactly
               node_mat += fwd_sat^T @ rve_sat  and
               short_mat += triu(fwd_sat^T @ fwd_sat + rve_sat^T @ rve_sat).
  mesh:   read batches are data-parallel across devices; integer count
          matrices merge with psum (associative + commutative => results are
          bit-identical to the serial loop for any sharding).

Saturation-test exactness: the reference computes
    expected = (min(rlen, reflen) - sl + 1) * (rlen - sl) / rlen
in float64 and tests v >= max(min(saturate, expected), 1)
(PE_Inference.py:39-47). Because `expected` is a ratio of integers with
denominator rlen, `v >= expected` differs between float64 and exact rational
arithmetic only if 0 < |expected - v| < ulp, impossible since the gap is a
multiple of 1/rlen; and equality is computed exactly by float64 division.
Hence the integer test  v*rlen >= A*(rlen-sl)  is bit-equivalent, and runs in
int32 on device.

Min-ref-coord cancellation: the reference tracks three stats per (read, node)
— hit count v, min ref coord c, min read k-index ki (PE_Inference.py:24-31) —
but its saturation bound uses only (R - L):
    L = max(c, c - ki) = c            (ki >= 0)
    R = min(c + reflen - 1, c - ki + rlen - 1)
    saturate = R - L - sl + 2 = min(reflen - 1, rlen - 1 - ki) - sl + 2
c drops out exactly, so the device kernels accumulate only (count, min
k-index) — one fewer table gather and one fewer min-reduction per probe,
bit-identical results (verified against the reference script itself in
tests/test_reference_diff.py).
"""

from __future__ import annotations

import logging
import os
import sys
from dataclasses import dataclass
from functools import partial
from typing import List, Optional, Sequence, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from vstrains_tpu.core.fastq import ReadPairBatch
from vstrains_tpu.core.seq import (HASH_MULT_1, HASH_MULT_2, _mult_pows,
                                   encode_seq, prefix_hash_weights,
                                   revcomp_codes, window_hashes_np)

_LOG = logging.getLogger(__name__)

_INF = np.int32(2**31 - 1)
_BIAS = np.uint32(0x80000000)


# --------------------------------------------------------------------------
# host: table construction
# --------------------------------------------------------------------------

@dataclass
class KmerTable:
    """Flat hash-sorted (k+1)-mer table over all node sequences, both strands.

    Entry value layout matches the reference's kmer_htable entries (node
    index, forward-strand offset) — the reverse-complement k-mer of a window
    maps to the *same* (node, offset) value (PE_Inference.py:123-135).
    """
    h1_biased: np.ndarray   # int32 [M], sorted (uint32 order via bias)
    h2: np.ndarray          # int32 [M] (bitcast uint32; equality compares)
    node: np.ndarray        # int32 [M]
    offset: np.ndarray      # int32 [M]
    max_dup: int            # max run length of equal h1
    num_nodes: int
    split_len: int
    seq_lens: np.ndarray    # int32 [N] node sequence lengths
    num_entries: int = 0    # real entries (arrays may be bucket-padded
                            # with never-matching sentinels)
    # direct-address index: bucket_starts[x] = first table position whose
    # h1 >> bucket_shift >= x. Turns the per-batch join into one gather
    # (no per-batch sort); the duplicate scan bounded by scan_depth (max
    # bucket population) then verifies exact hash equality.
    bucket_starts: Optional[np.ndarray] = None  # int32 [2^b + 1]
    bucket_shift: int = 32
    scan_depth: int = 1


def _table_device_arrays(table: "KmerTable", want_pays_bits=None):
    """Device-resident views of a table's arrays, memoized on the table.

    jnp.asarray re-transfers the same host array on EVERY call — at
    metaSPAdes scale the table + sortfill payloads are ~174 MB per
    engine call. Repeated infer calls — per-width-bucket parts, the
    oracle subsample, benchmarks — reuse one transfer. Keyed by the
    default device, so a run under another `jax_default_device` never
    reads buffers committed to a different device. Table arrays are
    immutable by contract once built."""
    dd = jax.config.jax_default_device
    dkey = str(dd) if dd is not None else jax.default_backend()
    cache = getattr(table, "_dev_cache", None)
    if cache is None:
        cache = {}
        setattr(table, "_dev_cache", cache)
    ent = cache.get(dkey)
    if ent is None:
        ent = {"h1": jnp.asarray(table.h1_biased),
               "seq_lens": jnp.asarray(table.seq_lens)}
        cache[dkey] = ent
    if want_pays_bits is not None and ("pays", want_pays_bits) not in ent:
        ent[("pays", want_pays_bits)] = jnp.asarray(
            _build_sortfill_payloads(table, want_pays_bits))
    return ent


def _bucket_size(n: int) -> int:
    """Round up to the next power of two (>= 1024): table/shape buckets
    keep jit shapes stable across datasets so compiled kernels are reused
    (each new shape costs a full XLA compile)."""
    size = 1024
    while size < n:
        size *= 2
    return size


_PARALLEL_SORT_MIN = 1 << 20  # entries; below this the serial sort wins


def _finish_kmer_table(h1, h2, node, offset, max_dup, num_nodes,
                       split_len, seq_lens, pad_to_bucket, bucket_index):
    """Common tail of build_kmer_table: bias/bitcast the sorted entry
    arrays, pad to the shape bucket, and (optionally) build the
    direct-address bucket index."""
    h1b = (h1 ^ _BIAS).view(np.int32)
    h2b = h2.view(np.int32)
    if pad_to_bucket and h1.size:
        m_pad = _bucket_size(h1.size)
        pad = m_pad - h1.size
        if pad:
            h1b = np.concatenate([h1b, np.full(pad, _INF, np.int32)])
            h2b = np.concatenate([h2b, np.full(pad, -1, np.int32)])
            node = np.concatenate([node, np.zeros(pad, np.int32)])
            offset = np.concatenate([offset, np.zeros(pad, np.int32)])

    # direct-address bucket index over the REAL entries (sentinel padding
    # excluded so it cannot inflate the scan depth). Only the explicit
    # 'lookup' probe reads it; with bucket_index='auto' a metaSPAdes-
    # scale table that the default sortfill probe will serve skips the
    # ~1.7 s bincount/cumsum build (bucket_starts=None -> the classic
    # fallback uses the sort-join, results unchanged).
    if bucket_index == "auto":
        bucket_index = not (h1.size >= _SORTFILL_STRIDE_MIN_TABLE
                            and _sortfill_node_bits(num_nodes) is not None
                            and 1 <= max_dup <= _SORTFILL_MAX_DUP)
    if not bucket_index:
        return KmerTable(
            bucket_starts=None,
            bucket_shift=32,
            scan_depth=max(max_dup, 1),
            h1_biased=h1b,
            h2=h2b,
            node=node,
            offset=offset,
            max_dup=max_dup,
            num_nodes=num_nodes,
            split_len=split_len,
            seq_lens=seq_lens,
            num_entries=int(h1.size),
        )
    if h1.size:
        bits = max(10, min(26, int(np.ceil(np.log2(2 * h1.size)))))
        shift = 32 - bits
        buckets = (h1 >> np.uint32(shift)).astype(np.int64)
        # starts[x] = #entries with bucket < x — a bincount prefix sum
        # (a searchsorted over the 2^bits arange cost ~15s at 29M entries)
        counts = np.bincount(buckets, minlength=(1 << bits))
        starts = np.empty((1 << bits) + 1, dtype=np.int64)
        starts[0] = 0
        np.cumsum(counts, out=starts[1:])
        starts = starts.astype(np.int32)
        scan_depth = int(counts.max())
    else:
        shift = 32
        starts = np.zeros(2, np.int32)
        scan_depth = 1

    return KmerTable(
        bucket_starts=starts,
        bucket_shift=shift,
        scan_depth=max(scan_depth, 1),
        h1_biased=h1b,
        h2=h2b,
        node=node,
        offset=offset,
        max_dup=max_dup,
        num_nodes=num_nodes,
        split_len=split_len,
        seq_lens=seq_lens,
        num_entries=int(h1.size),
    )


def build_kmer_table(seqs: Sequence[str], split_len: int,
                     pad_to_bucket: bool = True,
                     sp: Optional[tuple] = None,
                     bucket_index="auto") -> KmerTable:
    """Build the sorted dual-hash table of all valid (k+1)-mers (both
    strands) of every node sequence.

    With pad_to_bucket, entry arrays pad to a power-of-two bucket with
    never-matching sentinels (h1 = INT32_MAX biased, h2 = -1): the join
    places real queries before the sentinel run and the duplicate scan's
    hash-equality masks reject them, so results are unchanged while the
    device arrays keep bucket-stable shapes.

    `sp` = (mesh, min_len): node sequences of at least min_len codes are
    hashed by the sequence-parallel halo kernel over the mesh's 'data'
    axis (parallel/mesh.sp_window_hashes) — bit-identical to the host
    path, with the sequence sharded across devices (the long-context
    axis of SURVEY.md section 5)."""
    h1s: List[np.ndarray] = []
    h2s: List[np.ndarray] = []
    nodes: List[np.ndarray] = []
    offsets: List[np.ndarray] = []
    seq_lens = np.array([len(s) for s in seqs], dtype=np.int32)

    # C++ fast path (hash both strands + sort): bit-identical to the
    # numpy path below (tests/test_table_native.py A/Bs every field);
    # ~3.7 s -> ~0.4 s at metaSPAdes scale. The numpy path remains for
    # SP-sharded builds, the no-toolchain fallback, and as the oracle.
    if sp is None and os.environ.get("VSTRAINS_NATIVE_TABLE", "1") != "0":
        from vstrains_tpu import native as _native
        nat = _native.build_table_entries_native(seqs, split_len)
        if nat is not None:
            n_h1, n_h2, n_node, n_off, n_max_dup = nat
            return _finish_kmer_table(n_h1, n_h2, n_node, n_off,
                                      n_max_dup, len(seqs), split_len,
                                      seq_lens, pad_to_bucket,
                                      bucket_index)

    # Long nodes hash individually (optionally SP-sharded over the mesh);
    # everything else batches into ONE sentinel-separated concatenation
    # per strand so the whole host build is a handful of vectorized
    # passes instead of ~10 small numpy calls per node (at 50k nodes the
    # per-node loop alone cost ~40s). A window crossing a node boundary
    # necessarily contains the never-valid sentinel code, so boundary
    # windows drop out through the same validity mask as N bases.
    sp_min = sp[1] if sp is not None else None
    _CHUNK_CODES = 32 * 1024 * 1024  # bound the hashing temporaries
    parts: List[str] = []
    keep: List[int] = []
    klens: List[int] = []
    cat_len = 0

    def _flush():
        nonlocal parts, keep, klens, cat_len
        if not keep:
            return
        keep_a = np.asarray(keep, np.int32)
        klens_a = np.asarray(klens, np.int64)
        bounds = np.concatenate([[0], np.cumsum(klens_a + 1)])
        cat = encode_seq("N".join(parts))
        S = cat.shape[0]
        # one revcomp of the whole concatenation covers every node's rc
        # windows: the rc window at cat position p images the forward
        # window at q = S - L - p, so node lookup and the forward-offset
        # formula (PE_Inference.py:123-135 parity) are shared with the
        # forward strand via q.
        prefix_hash_weights(split_len, S)  # warm before the strand race

        def _strand(is_rc: bool):
            cc = revcomp_codes(cat) if is_rc else cat
            hh1, hh2, vv = window_hashes_np(cc, split_len)
            idx = np.nonzero(vv)[0]
            q = (S - split_len - idx) if is_rc else idx
            which = np.searchsorted(bounds, q, side="right") - 1
            return (hh1[idx], hh2[idx], keep_a[which],
                    (q - bounds[which]).astype(np.int32))

        # numpy releases the GIL in its inner loops, so the two strands
        # hash concurrently; results append in fixed (fwd, rc) order
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(2) as ex:
            futs = [ex.submit(_strand, False), ex.submit(_strand, True)]
            for fut in futs:
                hh1, hh2, nd, off = fut.result()
                h1s.append(hh1)
                h2s.append(hh2)
                nodes.append(nd)
                offsets.append(off)
        parts, keep, klens, cat_len = [], [], [], 0

    for i, seq in enumerate(seqs):
        n = len(seq)
        if n < split_len:
            continue
        if sp_min is not None and n >= sp_min:
            codes = encode_seq(seq)
            from vstrains_tpu.parallel.mesh import sp_window_hashes
            f1, f2, fv = sp_window_hashes(codes, split_len, sp[0],
                                          bucket=True)
            idx = np.nonzero(fv)[0]
            h1s.append(f1[idx])
            h2s.append(f2[idx])
            nodes.append(np.full(idx.shape, i, dtype=np.int32))
            offsets.append(idx.astype(np.int32))
            # rc window j <-> forward offset n-L-j
            r1, r2, rv = sp_window_hashes(revcomp_codes(codes), split_len,
                                          sp[0], bucket=True)
            jdx = np.nonzero(rv)[0]
            h1s.append(r1[jdx])
            h2s.append(r2[jdx])
            nodes.append(np.full(jdx.shape, i, dtype=np.int32))
            offsets.append((n - split_len - jdx).astype(np.int32))
            continue
        parts.append(seq if isinstance(seq, str) else seq.decode("ascii"))
        keep.append(i)
        klens.append(n)
        cat_len += n + 1
        if cat_len >= _CHUNK_CODES:
            _flush()
    _flush()

    if h1s:
        h1 = np.concatenate(h1s)
        h2 = np.concatenate(h2s)
        node = np.concatenate(nodes)
        offset = np.concatenate(offsets)
    else:
        h1 = np.zeros(0, np.uint32)
        h2 = np.zeros(0, np.uint32)
        node = np.zeros(0, np.int32)
        offset = np.zeros(0, np.int32)

    # (h1, h2, node, offset) order via a packed-u64 sort plus a tie
    # fix-up: equal (h1, h2) pairs across different (node, offset) are
    # hash collisions — vanishingly rare — so sorting just the tie runs
    # by the secondary key costs nothing while keeping the table order
    # fully input-order-independent (the equivalent 4-key lexsort cost
    # ~4x at metaSPAdes scale; all fields are non-negative and fit 32
    # bits, so the packing preserves the order). Above 1M entries the
    # sort partitions by the key's top byte (a contiguous h1 range each)
    # and sorts partitions in threads — numpy's sorts release the GIL —
    # with the permute and the per-partition max-h1-run folded in; the
    # tie canonization makes the result identical to the serial path.
    M_real = int(h1.size)
    if sys.byteorder == "little" and M_real:
        # u64 pack without the astype round-trips: write the 32-bit
        # halves straight into the packed array's lanes
        key_h = np.empty(M_real, np.uint64)
        kv = key_h.view(np.uint32)
        kv[0::2] = h2
        kv[1::2] = h1
    else:
        key_h = ((h1.astype(np.uint64) << np.uint64(32))
                 | h2.astype(np.uint64))

    def _canonize_ties(seg, ks):
        # seg: table-entry indices sorted by ks (their packed key);
        # reorder equal-key runs by (node, offset) so the final order is
        # independent of input order and of sort stability
        ties = np.flatnonzero(ks[1:] == ks[:-1])
        if ties.size:
            in_run = np.zeros(ks.shape[0], bool)
            in_run[ties] = True
            in_run[ties + 1] = True
            sub = np.flatnonzero(in_run)
            key_no = ((node[seg[sub]].astype(np.uint64) << np.uint64(32))
                      | offset[seg[sub]].astype(np.uint32))
            so = np.lexsort((key_no, ks[sub]))
            seg[sub] = seg[sub[so]]
        return seg

    def _max_h1_run(hs: np.ndarray) -> int:
        if not hs.size:
            return 0
        neq = np.flatnonzero(hs[1:] != hs[:-1])
        bnds = np.empty(neq.size + 2, np.int64)
        bnds[0] = -1
        bnds[1:-1] = neq
        bnds[-1] = hs.size - 1
        return int(np.diff(bnds).max())

    if M_real >= _PARALLEL_SORT_MIN:
        top = (h1 >> np.uint32(24)).astype(np.uint8)
        porder = np.argsort(top, kind="stable")  # O(n) uint8 radix
        pbnd = np.empty(257, np.int64)
        pbnd[0] = 0
        np.cumsum(np.bincount(top, minlength=256), out=pbnd[1:])
        h1o = np.empty_like(h1)
        h2o = np.empty_like(h2)
        nodeo = np.empty_like(node)
        offso = np.empty_like(offset)
        max_dup_parts = np.zeros(256, np.int64)

        def _sort_part(p):
            a, b = int(pbnd[p]), int(pbnd[p + 1])
            if a == b:
                return
            seg = porder[a:b]
            keys = key_h[seg]
            so = np.argsort(keys)
            seg = seg[so]
            seg = _canonize_ties(seg, keys[so])
            hs = h1[seg]
            h1o[a:b] = hs
            h2o[a:b] = h2[seg]
            nodeo[a:b] = node[seg]
            offso[a:b] = offset[seg]
            # equal h1 share the top byte, so h1 runs never cross
            # partition boundaries
            max_dup_parts[p] = _max_h1_run(hs)

        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(min(8, os.cpu_count() or 4)) as ex:
            list(ex.map(_sort_part, range(256)))
        h1, h2, node, offset = h1o, h2o, nodeo, offso
        max_dup = int(max_dup_parts.max())
    elif M_real:
        order = np.argsort(key_h, kind="stable")
        order = _canonize_ties(order, key_h[order])
        h1 = h1[order]
        h2 = h2[order]
        node = node[order]
        offset = offset[order]
        max_dup = _max_h1_run(h1)
    else:
        max_dup = 1

    return _finish_kmer_table(h1, h2, node, offset, max_dup, len(seqs),
                              split_len, seq_lens, pad_to_bucket,
                              bucket_index)


# --------------------------------------------------------------------------
# device: window hashes
# --------------------------------------------------------------------------

def _device_window_hashes(codes: jnp.ndarray, lens: jnp.ndarray,
                          split_len: int):
    """codes: uint8 [B, T]; returns (h1, h2) uint32 [B, K] and valid [B, K]
    where K = T - split_len + 1.

    Uses the prefix-sum factorization (core/seq.prefix_hash_weights): one
    uint32 cumsum along the read + a windowed difference + a per-window
    scale gives every window hash — O(T) per read instead of the O(L*K)
    shifted-add loop, bit-identical mod 2^32.

    A window is valid iff it lies within the read AND contains no BAD_CODE
    base: reads with non-ACGT non-'N' characters (IUPAC codes, lowercase,
    stray CR from CRLF files) pass the loader's N-filter, and their bad
    positions must never hash-match — reference parity: such string k-mers
    simply never equal a table k-mer."""
    B, T = codes.shape
    K = T - split_len + 1
    bad = (codes >= 4).astype(jnp.int32)
    c = jnp.where(codes < 4, codes, 0).astype(jnp.uint32) + jnp.uint32(1)

    (w1, s1), (w2, s2) = prefix_hash_weights(split_len, T)
    hs = []
    for w, s in ((w1, s1), (w2, s2)):
        p = jnp.cumsum(c * jnp.asarray(w)[None, :], axis=1)
        p = jnp.pad(p, ((0, 0), (1, 0)))
        hs.append((p[:, split_len:] - p[:, :K]) * jnp.asarray(s)[None, :])

    nb = jnp.cumsum(bad, axis=1)
    nb = jnp.pad(nb, ((0, 0), (1, 0)))
    nbad = nb[:, split_len:] - nb[:, :K]

    win = jax.lax.broadcasted_iota(jnp.int32, (B, K), 1)
    valid = ((win + split_len) <= lens[:, None]) & (nbad == 0)
    return hs[0], hs[1], valid


# --------------------------------------------------------------------------
# device: probe + per-read node stats + saturation
# --------------------------------------------------------------------------

def _probe_stats(codes, lens, tab_h1b, tab_h2, tab_node,
                 split_len: int, max_dup: int, num_nodes: int):
    """Per-(read, node) hit stats for one read end of a batch: (count,
    min read k-index), each int32 [B, N].

    Mirrors the accumulation loop of single_end_read_mapping
    (PE_Inference.py:24-31) for the whole batch at once, minus the min
    ref coord, which cancels out of the saturation test (module
    docstring). The stats are a commutative monoid (sum, min), so partial
    stats from disjoint table shards combine exactly with psum/pmin — the
    tensor-parallel path in parallel/mesh.py relies on this.
    """
    B = codes.shape[0]
    N = num_nodes
    h1, h2, valid = _device_window_hashes(codes, lens, split_len)
    K = h1.shape[1]

    q = (h1 ^ jnp.uint32(0x80000000)).astype(jnp.int32)
    lo = jnp.searchsorted(tab_h1b, q.ravel(), side="left").reshape(B, K)
    hi = jnp.searchsorted(tab_h1b, q.ravel(), side="right").reshape(B, K)

    bidx = jax.lax.broadcasted_iota(jnp.int32, (B, K), 0)
    kidx = jax.lax.broadcasted_iota(jnp.int32, (B, K), 1)

    cnt = jnp.zeros((B, N + 1), jnp.int32)
    kmin = jnp.full((B, N + 1), _INF, jnp.int32)

    h2q = h2.astype(jnp.int32)

    def body(d, state):
        cnt, kmin = state
        idx = lo + d
        m = (idx < hi) & valid
        idxc = jnp.where(m, idx, 0)
        e_h2 = tab_h2[idxc]
        e_node = tab_node[idxc]
        m = m & (e_h2 == h2q)
        node_t = jnp.where(m, e_node, N)  # slot N absorbs misses
        cnt = cnt.at[bidx, node_t].add(1)
        kmin = kmin.at[bidx, node_t].min(jnp.where(m, kidx, _INF))
        return cnt, kmin

    cnt, kmin = jax.lax.fori_loop(0, max_dup, body, (cnt, kmin))
    return cnt[:, :N], kmin[:, :N]


def _saturate(cnt, kmin, lens, seq_lens, split_len: int):
    """The reference saturation test in exact-integer form with the min
    ref coord cancelled (see module docstring); returns the per-(read,
    node) mask as float32 0/1."""
    hit = cnt > 0
    rl = lens[:, None].astype(jnp.int32)
    ref = seq_lens[None, :].astype(jnp.int32)
    kminz = jnp.where(hit, kmin, 0)
    sat_thresh = jnp.minimum(ref - 1, rl - 1 - kminz) - split_len + 2
    A = jnp.minimum(rl, ref) - split_len + 1
    exp_num = A * (rl - split_len)
    ok = hit & ((cnt >= sat_thresh) | (cnt * rl >= exp_num))
    return ok.astype(jnp.float32)


def _probe_and_saturate(codes, lens, tab_h1b, tab_h2, tab_node,
                        seq_lens, split_len: int, max_dup: int,
                        num_nodes: int):
    """One read end for a whole batch -> saturated mask [B, N] (float32 0/1).

    Mirrors single_end_read_mapping (PE_Inference.py:16-48) for every read of
    the batch at once.
    """
    cnt, kmin = _probe_stats(codes, lens, tab_h1b, tab_h2, tab_node,
                             split_len, max_dup, num_nodes)
    return _saturate(cnt, kmin, lens, seq_lens, split_len)


# --------------------------------------------------------------------------
# sort-merge-join probe
#
# The probe is a compare-free sort-merge join: stable-argsort the
# concatenation [query_hashes, table_hashes]; each query's join position
# (count of table entries before it) falls out of one exclusive cumsum.
# Equality verification then happens inside the bounded duplicate-scan
# loop. The binary-search probe (jnp.searchsorted) is kept as a
# cross-check. Which probe is fastest on the GPU is not measured yet
# (ROADMAP.md).
#
# These split stages (hash+join / stats / matmuls) serve the cross-check
# probes and the sharded engines; the default driver runs the fused
# single-dispatch kernel (_pe_batch_fused).
# --------------------------------------------------------------------------

def _hash_join_impl(codes, lens, tab_h1, split_len: int):
    """Window hashes + sort-merge join -> per-window table position `lo`
    (index of the first table entry >= query h1). Unjitted body — reused
    by the per-shard data-parallel step in parallel/mesh.py."""
    h1q, h2q, valid = _device_window_hashes(codes, lens, split_len)
    B, K = h1q.shape
    q1 = (h1q ^ jnp.uint32(0x80000000)).astype(jnp.int32)
    q1f = q1.ravel()
    Q = q1f.shape[0]
    a = jnp.concatenate([q1f, tab_h1])  # queries first => 'left' boundary
    perm = jnp.argsort(a, stable=True)
    is_tab = perm >= Q
    it32 = is_tab.astype(jnp.int32)
    tab_before = jnp.cumsum(it32) - it32  # exclusive prefix of table count
    qpos_c = jnp.where(is_tab, Q, perm)
    lo = jnp.zeros(Q, jnp.int32).at[qpos_c].set(
        tab_before, mode="drop").reshape(B, K)
    return q1, h2q.astype(jnp.int32), valid, lo


_hash_join_kernel = partial(jax.jit, static_argnames=("split_len",))(
    _hash_join_impl)


def _hash_lookup_impl(codes, lens, bucket_starts, tab_h1, split_len: int,
                      shift: int, probe_depth: int):
    """Window hashes + two-phase direct-address table lookup.

    Replaces the per-batch sort-merge join: one gather into the
    host-built bucket index (bucket = h1 >> shift over the hash-sorted
    table) lands at the query's bucket, then a CHEAP find loop (one
    h1 gather + compare per step, bounded by the max bucket population)
    locates the exact start of the query's equal-h1 run — runs are
    contiguous and never cross buckets, so the first in-bucket h1 match
    IS the run start. The heavy stats stage then scans only true
    duplicates (max_dup), exactly like the sort join, without the
    O((Q+M) log^2) per-batch sort.
    """
    h1q, h2q, valid = _device_window_hashes(codes, lens, split_len)
    bucket = (h1q >> jnp.uint32(shift)).astype(jnp.int32)
    base = bucket_starts[bucket]
    q1 = (h1q ^ jnp.uint32(0x80000000)).astype(jnp.int32)
    M = tab_h1.shape[0]

    def body(p, found):
        idx = jnp.minimum(base + p, M - 1)
        hit = (tab_h1[idx] == q1) & (base + p < M) & (found == M)
        return jnp.where(hit, idx, found)

    lo = jax.lax.fori_loop(0, probe_depth, body,
                           jnp.full(q1.shape, M, jnp.int32))
    return q1, h2q.astype(jnp.int32), valid, lo


_hash_lookup_kernel = partial(
    jax.jit, static_argnames=("split_len", "shift", "probe_depth"))(
    _hash_lookup_impl)


def _dup_scan_stats_impl(q1, h2qi, valid, lo, tab_h1, tab_h2,
                         tab_node, max_dup: int, num_nodes: int):
    """Bounded duplicate scan from `lo` with in-loop hash-equality masks,
    scatter-accumulated per-(read, node) stats (count, min-kindex).
    Shared by the single-chip kernel and the tensor-parallel per-shard
    step (parallel/mesh.py)."""
    B, K = q1.shape
    M = tab_h1.shape[0]
    N = num_nodes
    loc = jnp.minimum(lo, M - 1)
    bidx = jax.lax.broadcasted_iota(jnp.int32, (B, K), 0)
    kidx = jax.lax.broadcasted_iota(jnp.int32, (B, K), 1)
    cnt = jnp.zeros((B, N + 1), jnp.int32)
    kmin = jnp.full((B, N + 1), _INF, jnp.int32)

    def body(d, state):
        cnt, kmin = state
        idxc = jnp.minimum(loc + d, M - 1)
        e_h1 = tab_h1[idxc]
        e_h2 = tab_h2[idxc]
        e_node = tab_node[idxc]
        m = valid & (e_h1 == q1) & (e_h2 == h2qi) & (loc + d < M)
        node_t = jnp.where(m, e_node, N)
        cnt = cnt.at[bidx, node_t].add(1)
        kmin = kmin.at[bidx, node_t].min(jnp.where(m, kidx, _INF))
        return cnt, kmin

    cnt, kmin = jax.lax.fori_loop(0, max_dup, body, (cnt, kmin))
    return cnt[:, :N], kmin[:, :N]


def _dup_scan_stats_onehot_impl(q1, h2qi, valid, lo, tab_h1, tab_h2,
                                tab_node, max_dup: int, num_nodes: int):
    """Scatter-free variant of the duplicate-scan stats: the per-(read,
    node) accumulation is a masked one-hot compare + reduce over windows
    (B*K*N elementwise ops, fully fusable) instead of two XLA scatters
    per depth step (see _stats_impl_choice)."""
    B, K = q1.shape
    M = tab_h1.shape[0]
    N = num_nodes
    loc = jnp.minimum(lo, M - 1)
    kidx = jax.lax.broadcasted_iota(jnp.int32, (B, K), 1)
    ns = jax.lax.broadcasted_iota(jnp.int32, (1, 1, N), 2)
    cnt = jnp.zeros((B, N), jnp.int32)
    kmin = jnp.full((B, N), _INF, jnp.int32)

    def body(d, state):
        cnt, kmin = state
        idxc = jnp.minimum(loc + d, M - 1)
        e_h1 = tab_h1[idxc]
        e_h2 = tab_h2[idxc]
        e_node = tab_node[idxc]
        m = valid & (e_h1 == q1) & (e_h2 == h2qi) & (loc + d < M)
        oh = m[:, :, None] & (e_node[:, :, None] == ns)
        cnt = cnt + oh.astype(jnp.int32).sum(axis=1)
        kmin = jnp.minimum(
            kmin, jnp.where(oh, kidx[:, :, None], _INF).min(axis=1))
        return cnt, kmin

    return jax.lax.fori_loop(0, max_dup, body, (cnt, kmin))


STATS_IMPLS = ("scatter", "onehot")


def _stats_impl_choice(num_nodes: int, n_windows: int,
                       max_dup: int) -> str:
    """Pick the per-(read, node) stats accumulator from the shape alone.

    'scatter' writes each matched slot once into the (B, N+1) count and
    min-k planes (atomics on the GPU); 'onehot' compares every slot with
    every node and reduces over the windows (B*C*N compares that XLA
    fuses with the gathers feeding them). Both are bit-identical.
    VSTRAINS_STATS_IMPL forces either one.

    Timed end to end through infer_pe_links on one H100 80GB HBM3 at a
    700 W limit (tools/stats_impl_bench.py, PERF.md): scatter won at both
    shapes measured — the HIV labmix (N=773, 250 bp) by ~7-9x and the
    bench.py shape (N=100, 150 bp) by ~1.2-1.8x — so it is the default
    at every shape.
    """
    forced = os.environ.get("VSTRAINS_STATS_IMPL")
    if forced in STATS_IMPLS:
        return forced
    return "scatter"


@partial(jax.jit,
         static_argnames=("split_len", "max_dup", "num_nodes",
                          "stats_impl"))
def _stats_saturate_kernel(q1, h2qi, valid, lo, lens, tab_h1, tab_h2,
                           tab_node, seq_lens, split_len: int,
                           max_dup: int, num_nodes: int,
                           stats_impl: str = "scatter"):
    """Duplicate-scan stats + saturation test (single-chip jit)."""
    if stats_impl == "onehot":
        cnt, kmin = _dup_scan_stats_onehot_impl(
            q1, h2qi, valid, lo, tab_h1, tab_h2, tab_node, max_dup,
            num_nodes)
    else:
        cnt, kmin = _dup_scan_stats_impl(q1, h2qi, valid, lo, tab_h1,
                                         tab_h2, tab_node, max_dup,
                                         num_nodes)
    return _saturate(cnt, kmin, lens, seq_lens, split_len)


@partial(jax.jit, static_argnames=("num_nodes",))
def _pair_matmuls_jit(f, r, num_nodes: int):
    return _pair_matmuls(f, r, num_nodes)


# --------------------------------------------------------------------------
# payload-carrying sort-merge join ("sortfill" probe)
#
# The classic join (sort -> scatter lo -> 3 random table gathers in the
# stats) moves every payload through gathers. This probe removes them:
# the table payload rides the sort as an extra operand
# (pre-shifted per duplicate rank on host), a reverse first-valid scan
# broadcasts each run's table entries to the queries of the run, and one
# scatter per rank returns packed results to query order.
#
# Payload packing (adaptive): bit31 tag | h2_bits of h2's top bits |
# node_bits = max(9, bits(N-1)) node id, with h2_bits = 31 - node_bits.
# The secondary-hash check narrows from 32 to h2_bits bits (total verify
# 32 + h2_bits >= 45 bits with the exact h1 join); the reference compares
# exact strings, and the engine's dual-hash equality was already a
# documented approximation (docs/DIVERGENCES.md) — <= 2^-45 per-probe
# collision odds keep it far below any practical dataset's horizon.
# Graphs beyond 2^18 nodes (h2 check would drop under 13 bits) use the
# classic join.
# --------------------------------------------------------------------------

_SORTFILL_MAX_NODE_BITS = 18
_SORTFILL_MAX_DUP = 16
# subsample the table keys riding the per-batch sort once the table is
# large enough for the saved sort volume to beat the extra block gather
# (outputs identical at any stride — pure perf tuning). The thresholds
# are not yet tuned on the GPU (ROADMAP.md).
_SORTFILL_STRIDE = 4
_SORTFILL_STRIDE_MIN_TABLE = 2_000_000
_SORTFILL_STRIDE8_MIN_TABLE = 8_000_000


def _sortfill_stride(num_entries: int) -> int:
    forced = os.environ.get("VSTRAINS_SORTFILL_STRIDE")
    if forced:
        return max(1, int(forced))
    if num_entries >= _SORTFILL_STRIDE8_MIN_TABLE:
        return 8
    return (_SORTFILL_STRIDE
            if num_entries >= _SORTFILL_STRIDE_MIN_TABLE else 1)


def _sortfill_node_bits(num_nodes: int):
    """Payload node-id width for a graph, or None when the graph is too
    large for the packed-payload probe. A function of N alone so every
    backend/mesh picks the same probe (bit-identical outputs)."""
    bits = max(9, int(num_nodes - 1).bit_length()) if num_nodes > 1 else 9
    return bits if bits <= _SORTFILL_MAX_NODE_BITS else None


def _build_sortfill_payloads(table: "KmerTable", node_bits: int = 9):
    """Host-built payload matrix, int32 [M, D], D = min(max_dup, cap).

    pays[i, d] packs (tag, h2 top bits, node) of table entry i+d when
    entries i..i+d share one h1 (they are consecutive in the hash-sorted
    table), else 0 (no tag bit -> never matches). One matrix instead of
    D separate arrays so the cummin fill fetches all ranks of an entry
    with a single row gather (contiguous D-element rows amortize the
    random-access latency that made per-rank gathers the sparse path's
    floor)."""
    h1 = table.h1_biased
    h2u = table.h2.view(np.uint32)
    node = table.node.astype(np.uint32)
    M = h1.shape[0]
    D = min(table.max_dup, _SORTFILL_MAX_DUP)
    h2_bits = 31 - node_bits
    h2_shift = np.uint32(32 - h2_bits)
    pays = np.zeros((M, D), dtype=np.uint32)
    for d in range(D):
        same = np.zeros(M, dtype=bool)
        h2p = np.zeros(M, dtype=np.uint32)
        nd = np.zeros(M, dtype=np.uint32)
        if d == 0:
            same[:] = True
            h2p[:] = h2u >> h2_shift
            nd[:] = node
        elif M > d:
            same[: M - d] = h1[d:] == h1[:-d]
            h2p[: M - d] = h2u[d:] >> h2_shift
            nd[: M - d] = node[d:]
        pays[:, d] = np.where(same,
                              np.uint32(1 << 31) | (h2p << node_bits) | nd,
                              np.uint32(0))
    return pays.view(np.int32)


def _sortfill_node_slots(codes, lens, tab_h1, pays, split_len: int,
                         num_nodes: int, fill: str = "cummin",
                         node_bits: int = 9, stride: int = 1):
    """Probe + per-slot matched node ids without a full-table gather.

    Returns node_t int32 [B, K*D] (k-major slots, sentinel num_nodes for
    misses) — the direct input of the slot accumulators.

    Two bit-identical fill implementations:
      * 'scan' — the payloads ride the sort as extra operands and a
        reverse first-valid associative scan broadcasts each run's table
        entries to its queries. Zero gathers, but the unrolled
        multi-operand scan tree is an XLA compile bomb (minutes, where
        the classic join compiles in seconds).
      * 'cummin' — the sort carries only (key, iota); because the table
        is hash-sorted, table rows appear in ascending order inside the
        stable sort output, so the nearest table entry at-or-after each
        position is just a reverse cummin of the row number (and its key
        a reverse cummin of the masked key). Payloads then come from D
        small gathers indexed by table row. Two primitive cumulative
        ops compile in seconds.

    stride > 1 (cummin only) subsamples the table keys riding the sort:
    only every stride-th entry (each S-block's LAST key) is an anchor.
    A matching run starting at i* has h1[i*-1] < q strictly, so the
    nearest anchor at-or-after a query is always floor(i*/S) — the run
    start is recovered by one contiguous (B, K, S) block gather +
    compare. At metaSPAdes scale the table dominates the sorted keys
    (14.5M of 17.6M at N=50k), so S=4 cuts the per-batch sort ~62% for
    one extra block-row gather; outputs are bit-identical for any
    stride (the same matches are found)."""
    h1q, h2q, valid = _device_window_hashes(codes, lens, split_len)
    B, K = h1q.shape
    q1f = (h1q ^ jnp.uint32(0x80000000)).astype(jnp.int32).ravel()
    Q = q1f.shape[0]
    M = tab_h1.shape[0]
    h2_bits = 31 - node_bits
    h2_mask = jnp.int32((1 << h2_bits) - 1)
    node_mask = jnp.int32((1 << node_bits) - 1)
    h2q_top = (h2q >> jnp.uint32(32 - h2_bits)).astype(jnp.int32)

    D = pays.shape[1]
    if fill == "cummin":
        if stride > 1:
            S = stride
            M_S = -(-M // S)
            # pad to a full block grid; _INF padding sorts last and any
            # false block-compare hit lands on a payload row >= M, which
            # the fill-value-0 pays gather turns into a miss (no tag bit)
            blocked = jnp.concatenate(
                [tab_h1, jnp.full(M_S * S - M, _INF, jnp.int32)]
            ).reshape(M_S, S)
            anchors = blocked[:, S - 1]
            key = jnp.concatenate([q1f, anchors])
            iota = jax.lax.iota(jnp.int32, Q + M_S)
            skey, siota = jax.lax.sort((key, iota), num_keys=1,
                                       is_stable=True)
            arow = jnp.where(siota >= Q, siota - Q, M_S)
            ta = jax.lax.cummin(arow, axis=0, reverse=True)
            qpos = jnp.where(siota < Q, siota, Q)
            ta_q = jnp.full(Q, M_S, jnp.int32).at[qpos].set(
                jnp.where(siota < Q, ta, M_S),
                mode="drop").reshape(B, K)
            h1_blk = jnp.take(blocked, ta_q, axis=0, mode="fill",
                              fill_value=_INF)             # (B, K, S)
            q3 = q1f.reshape(B, K)[:, :, None]
            mm = h1_blk == q3
            sidx = jax.lax.broadcasted_iota(jnp.int32, (B, K, S), 2)
            p = jnp.where(mm, sidx, S).min(axis=2)
            ti_q = jnp.where(p < S, ta_q * S + p, M)
        else:
            key = jnp.concatenate([q1f, tab_h1])
            iota = jax.lax.iota(jnp.int32, Q + M)
            skey, siota = jax.lax.sort((key, iota), num_keys=1,
                                       is_stable=True)
            row = jnp.where(siota >= Q, siota - Q, M)
            ti = jax.lax.cummin(row, axis=0, reverse=True)
            tkey = jnp.where(siota >= Q, skey, _INF)
            fkey = jax.lax.cummin(tkey, axis=0, reverse=True)
            okk = (ti < M) & (fkey == skey) & (siota < Q)
            qpos = jnp.where(siota < Q, siota, Q)
            ti_q = jnp.full(Q, M, jnp.int32).at[qpos].set(
                jnp.where(okk, ti, M), mode="drop").reshape(B, K)
        # all D duplicate ranks of an entry in one contiguous row gather
        outp = jnp.take(pays, ti_q, axis=0, mode="fill",
                        fill_value=0)                      # (B, K, D)
        m = (valid[:, :, None] & (outp < 0)
             & (((outp >> node_bits) & h2_mask) == h2q_top[:, :, None]))
        return jnp.where(m, outp & node_mask,
                         num_nodes).reshape(B, K * D)

    key = jnp.concatenate([q1f, tab_h1])
    iota = jax.lax.iota(jnp.int32, Q + M)
    zq = jnp.zeros(Q, jnp.int32)
    ops = (key, iota) + tuple(jnp.concatenate([zq, pays[:, d]])
                              for d in range(D))
    skey, siota, *spays = jax.lax.sort(ops, num_keys=1, is_stable=True)
    is_tab = (siota >= Q).astype(jnp.int32)

    def fop(a, b):
        # under reverse=True jax flips the operand array, so the RIGHT
        # combine operand (b) holds the earlier original positions —
        # preferring b-when-valid yields the NEAREST table entry
        # at-or-after each position
        av, *ax = a
        bv, *bx = b
        take_b = bv == 1
        return (av | bv,) + tuple(jnp.where(take_b, y, x)
                                  for x, y in zip(ax, bx))

    fv, fkey, *fpays = jax.lax.associative_scan(
        fop, (is_tab, skey) + tuple(spays), reverse=True)
    okk = (fv == 1) & (fkey == skey) & (siota < Q)
    qpos = jnp.where(siota < Q, siota, Q)
    slots = []
    for fp in fpays:
        outp = jnp.zeros(Q, jnp.int32).at[qpos].set(
            jnp.where(okk, fp, 0), mode="drop").reshape(B, K)
        m = (valid & (outp < 0)
             & (((outp >> node_bits) & h2_mask) == h2q_top))
        slots.append(jnp.where(m, outp & node_mask, num_nodes))
    return jnp.stack(slots, axis=2).reshape(B, K * D)


def _slots_onehot_accum(node_t, depth: int, num_nodes: int):
    """(count, min-kindex) from per-slot node ids via one-hot compare
    (the slot form of _dup_scan_stats_onehot_impl)."""
    B, C = node_t.shape
    ns = jax.lax.broadcasted_iota(jnp.int32, (1, 1, num_nodes), 2)
    oh = node_t[:, :, None] == ns
    cnt = oh.astype(jnp.int32).sum(axis=1)
    kidx = jax.lax.broadcasted_iota(jnp.int32, (1, C, 1), 1) // depth
    kmin = jnp.where(oh, kidx, _INF).min(axis=1)
    return cnt, kmin


def _slots_scatter_accum(node_t, depth: int, num_nodes: int):
    """(count, min-kindex) from per-slot node ids via scatter (one write
    per slot, against the one-hot's B*C*N compares). Miss slots carry
    the sentinel num_nodes and land in a dropped column."""
    B, C = node_t.shape
    rows = jax.lax.broadcasted_iota(jnp.int32, (B, C), 0)
    kidx = jax.lax.broadcasted_iota(jnp.int32, (1, C), 1) // depth
    kidx = jnp.broadcast_to(kidx, (B, C))
    cnt = jnp.zeros((B, num_nodes + 1), jnp.int32).at[rows, node_t].add(
        1, mode="drop")
    kmin = jnp.full((B, num_nodes + 1), _INF, jnp.int32).at[
        rows, node_t].min(kidx, mode="drop")
    return cnt[:, :num_nodes], kmin[:, :num_nodes]


# --------------------------------------------------------------------------
# sparse per-batch stats (large-N path)
#
# The dense stats tensors are (2B, N+1) int32 x3 — at metaSPAdes scale
# (N ~ 50k nodes) they would force the batch below sort-join amortization.
# This path never materializes anything N-wide per batch: expanded
# (window, table-entry) matches are row-sorted by node id, per-(read, node)
# stats fall out of segmented scans over each row, and the saturated nodes
# compact into a small (2B, cap) list. Link counts then accumulate
# sparsely on host as (u*N+v) -> count COO pairs.
# --------------------------------------------------------------------------

def _segmented_scans(startf, start_val, kidx_s):
    """Row-wise segmented (max, min) scans with reset flags: within each
    run (segment) of a sorted row, propagates the run's start position
    and min k-index. One associative scan, shared flags."""

    def comb(a, b):
        fa, sa, ka = a
        fb, sb, kb = b
        return (fa | fb,
                jnp.where(fb, sb, jnp.maximum(sa, sb)),
                jnp.where(fb, kb, jnp.minimum(ka, kb)))

    _, startpos, kmin = jax.lax.associative_scan(
        comb, (startf, start_val, kidx_s), axis=1)
    return startpos, kmin


def _sparse_expand_matches(q1, h2qi, valid, lo, tab_h1, tab_h2,
                           tab_node, depth: int):
    """Classic-probe match expansion: bounded duplicate scan from `lo`
    flattened to per-slot (node id, k-index) planes [B2, K*depth]
    (sentinel _INF for misses) — the sparse tail's input format. Shared
    by the single-chip sparse kernel and the per-table-shard TP step."""
    B2, K = q1.shape
    M = tab_h1.shape[0]
    loc = jnp.minimum(lo, M - 1)
    d = jax.lax.broadcasted_iota(jnp.int32, (1, 1, depth), 2)
    idx = jnp.minimum(loc[:, :, None] + d, M - 1)
    e_h1 = tab_h1[idx]
    e_h2 = tab_h2[idx]
    e_node = tab_node[idx]
    m = (valid[:, :, None] & (e_h1 == q1[:, :, None])
         & (e_h2 == h2qi[:, :, None]) & (loc[:, :, None] + d < M))

    R = K * depth
    node_key = jnp.where(m, e_node, _INF).reshape(B2, R)
    kidx = jax.lax.broadcasted_iota(jnp.int32, (B2, K, depth), 1)
    kidx_v = jnp.where(m, kidx, _INF).reshape(B2, R)
    return node_key, kidx_v


@partial(jax.jit, static_argnames=("split_len", "depth", "cap",
                                   "cap_c"))
def _stats_sparse_kernel(q1, h2qi, valid, lo, lens, tab_h1, tab_h2,
                         tab_node, seq_lens, split_len: int,
                         depth: int, cap: int, cap_c: int = 32):
    """Per-read saturated node lists without any N-wide tensor.

    Returns (sat_nodes [2B, cap] int32 ascending, -1 padded; overflow
    bool: some read saturated more than cap nodes (or matched more
    than cap_c distinct nodes) — the driver retries the whole run with
    larger caps, results unchanged)."""
    K = q1.shape[1]
    node_key, kidx_v = _sparse_expand_matches(
        q1, h2qi, valid, lo, tab_h1, tab_h2, tab_node, depth)
    out, overflow, counts = _sparse_sat_tail(
        node_key, kidx_v, lens, seq_lens, split_len, cap, kmax=K,
        cap_c=cap_c)
    return _sat_two_tier(out, overflow, counts, cap)


def _row_run_stats(node_key, kidx_v, num_nodes: int,
                   kmax: Optional[int] = None):
    """Row-sort matched (node, k-index) slots and reduce each equal-node
    run to (count, min-k) via segmented scans.

    Returns (node_s, cnt, kmin, is_end), all [B2, R]: the sorted node
    ids, the running per-run count / min-k (exact at run-end positions),
    and the run-end mask (sentinel runs excluded). Shared by the
    single-chip sparse tail and the per-table-shard TP step in
    parallel/mesh.py (whose (sum, min) partials merge exactly).

    With `kmax` (a static bound on kidx values, exclusive) and node ids
    small enough that (node << kbits | kidx) fits int31, the row-sort
    carries ONE packed operand instead of two and the segmented scan one
    packed plane instead of two — the packed value preserves the
    (node, kidx) lexicographic order the two-operand stable sort
    produced, so every downstream quantity (per-run count, min-k, run
    node) is bit-identical, with half the sort operands and scan
    planes."""
    B2, R = node_key.shape
    N = num_nodes
    kbits = max(1, int(kmax - 1).bit_length()) if kmax else None
    packed = (kmax is not None
              and ((N - 1) << kbits) | (kmax - 1) < 2**31 - 1
              and ((R - 1) << kbits) | (kmax - 1) < 2**31 - 1)
    if packed:
        kmask = jnp.int32((1 << kbits) - 1)
        v = jnp.where(node_key == _INF, _INF,
                      (node_key << kbits) | kidx_v)
        v_s = jax.lax.sort(v, dimension=1)
        node_s = jnp.where(v_s == _INF, _INF, v_s >> kbits)
        kidx_s = v_s & kmask
    else:
        node_s, kidx_s = jax.lax.sort(
            (node_key, kidx_v), dimension=1, num_keys=1)

    prev = jnp.concatenate(
        [jnp.full((B2, 1), -1, jnp.int32), node_s[:, :-1]], axis=1)
    startf = node_s != prev
    pos = jax.lax.broadcasted_iota(jnp.int32, (B2, R), 1)
    if packed:
        # one scan plane: segment-start (pos, kidx) packed together.
        # kidx at the run start IS the run's min-k (the packed sort
        # orders kidx ascending within each node run). Propagating each
        # run's start value is a plain running max: start values
        # (pos << kbits | kidx) strictly increase with pos within a
        # row and non-starts carry -1, so the most recent start IS the
        # prefix max — one cummax primitive instead of a two-plane
        # associative scan (bit-identical).
        sv = jnp.where(startf, (pos << kbits) | kidx_s, -1)
        ps = jax.lax.cummax(sv, axis=1)
        startpos = ps >> kbits
        kmin = ps & kmask
    else:
        start_val = jnp.where(startf, pos, -1)
        startpos, kmin = _segmented_scans(startf, start_val, kidx_s)

    nxt = jnp.concatenate(
        [node_s[:, 1:], jnp.full((B2, 1), -1, jnp.int32)], axis=1)
    is_end = (node_s != nxt) & (node_s != _INF)
    cnt = pos - startpos + 1
    return node_s, cnt, kmin, is_end


def _sat_ok(node_s, cnt, kmin, lens, seq_lens, split_len: int):
    """The reference saturation test (PE_Inference.py:39-47) in exact
    integers — same algebra as _saturate (min ref coord cancelled, see
    module docstring). Evaluated elementwise; callers mask to run-end
    positions."""
    rl = lens[:, None].astype(jnp.int32)
    N = seq_lens.shape[0]
    ref = jnp.take(seq_lens, jnp.clip(node_s, 0, N - 1)).astype(jnp.int32)
    sat_thresh = jnp.minimum(ref - 1, rl - 1 - kmin) - split_len + 2
    A = jnp.minimum(rl, ref) - split_len + 1
    exp_num = A * (rl - split_len)
    return (cnt >= sat_thresh) | (cnt * rl >= exp_num)


def _compact_rows(ok, node_s, cap: int):
    """Compact the ok-masked entries of each row into a (B2, cap) list
    (-1 padded, source order preserved), with the per-row counts and a
    global cap-overflow flag."""
    B2, R = node_s.shape
    sidx = jnp.cumsum(ok.astype(jnp.int32), axis=1) - 1
    overflow = jnp.any(ok & (sidx >= cap))
    row = jax.lax.broadcasted_iota(jnp.int32, (B2, R), 0)
    tgt = jnp.where(ok & (sidx < cap), sidx, cap)
    out = jnp.full((B2, cap), -1, jnp.int32).at[row, tgt].set(
        node_s, mode="drop")
    counts = sidx[:, -1] + 1
    return out, overflow, counts


def _sort_compact_runs(node_s, cnt, kmin, is_end, cap_c: int):
    """Compact every run-end (node, count, min-k) triple to the first
    cap_c columns via ONE multi-operand row sort keyed on the candidate
    index (run ends appear node-ascending, so the compacted order
    matches the scatter compaction bit-for-bit). Returns (valid, node,
    cnt, kmin) as (B2, cap_c) planes + the candidate-overflow flag."""
    B2, R = node_s.shape
    csidx = jnp.cumsum(is_end.astype(jnp.int32), axis=1) - 1
    cand_ovf = jnp.any(is_end & (csidx >= cap_c))
    key = jnp.where(is_end & (csidx < cap_c), csidx, _INF)
    key_s, node_c, cnt_c, kmin_c = jax.lax.sort(
        (key, node_s, cnt, kmin), dimension=1, num_keys=1)
    valid = key_s[:, :cap_c] != _INF
    return (valid, node_c[:, :cap_c], cnt_c[:, :cap_c],
            kmin_c[:, :cap_c], cand_ovf)


def _sparse_sat_tail(node_key, kidx_v, lens, seq_lens, split_len: int,
                     cap: int, kmax: Optional[int] = None,
                     cap_c: int = 32):
    """Shared tail of the sparse stats kernels: row-sort matched
    (node, k-index) slots, segmented scans for per-run (count, min-k),
    then TWO-PHASE saturation: compact ALL runs to (B2, cap_c) first
    (one cheap multi-operand sort) and run the reference saturation
    test on the narrow planes, so the seq_lens gather touches (B2,
    cap_c) positions instead of all (B2, R) — ~R/cap_c x fewer. A read with more than cap_c DISTINCT
    matched nodes raises the overflow flag and the driver retries with
    larger caps — results unchanged (same contract as the saturated
    cap)."""
    node_s, cnt, kmin, is_end = _row_run_stats(
        node_key, kidx_v, seq_lens.shape[0], kmax)
    if cap_c >= node_s.shape[1]:
        # cap_c covers every slot: the narrow phase cannot drop runs
        ok = is_end & _sat_ok(node_s, cnt, kmin, lens, seq_lens,
                              split_len)
        return _compact_rows(ok, node_s, cap)
    valid, node_c, cnt_c, kmin_c, cand_ovf = _sort_compact_runs(
        node_s, cnt, kmin, is_end, cap_c)
    ok = valid & _sat_ok(node_c, cnt_c, kmin_c, lens, seq_lens,
                         split_len)
    node_m = jnp.where(ok, node_c, _INF)
    out, ovf2, counts = _compact_rows(ok, node_m, cap)
    return out, cand_ovf | ovf2, counts


def _sparse_run_stats_compact(node_key, kidx_v, num_nodes: int,
                              kmax: Optional[int], cap_c: int):
    """Per-shard candidate lists for the table-parallel sparse engine:
    every distinct matched node of each read with its LOCAL (count,
    min-k) partial, compacted to (B2, cap_c) triple lists (-1 / 0 / _INF
    padded, node-ascending). The (sum, min) partials from different
    table shards merge exactly in _sparse_merge_sat_tail — integer sums
    and mins are associative+commutative, the same monoid argument as
    the dense TP path (parallel/mesh.py)."""
    node_s, cnt, kmin, is_end = _row_run_stats(
        node_key, kidx_v, num_nodes, kmax)
    valid, node_c, cnt_c, kmin_c, overflow = _sort_compact_runs(
        node_s, cnt, kmin, is_end, min(cap_c, node_s.shape[1]))
    pad = cap_c - node_c.shape[1]
    nodes = jnp.where(valid, node_c, -1)
    cnts = jnp.where(valid, cnt_c, 0)
    kmins = jnp.where(valid, kmin_c, _INF)
    if pad > 0:  # cap_c exceeded the slot width; pad the planes
        nodes = jnp.pad(nodes, ((0, 0), (0, pad)), constant_values=-1)
        cnts = jnp.pad(cnts, ((0, 0), (0, pad)))
        kmins = jnp.pad(kmins, ((0, 0), (0, pad)),
                        constant_values=_INF)
    return nodes, cnts, kmins, overflow


def _sparse_merge_sat_tail(nodes, cnts, kmins, lens, seq_lens,
                           split_len: int, cap: int):
    """Merge gathered per-shard candidate lists into the global
    saturated-node lists: row-sort by node id (carrying the partial
    count / min-k), segmented (sum, min) scans reduce each node's
    partials from every table shard, then the shared saturation test +
    compaction. Padding entries (node -1 -> sentinel, count 0, kmin
    _INF) sort last and are excluded by the run-end mask."""
    node_key = jnp.where(nodes >= 0, nodes, _INF)
    node_s, cnt_s, kmin_s = jax.lax.sort(
        (node_key, cnts, kmins), dimension=1, num_keys=1)
    B2, C = node_s.shape
    prev = jnp.concatenate(
        [jnp.full((B2, 1), -1, jnp.int32), node_s[:, :-1]], axis=1)
    startf = node_s != prev

    def comb(a, b):
        fa, ca, ka = a
        fb, cb, kb = b
        return (fa | fb,
                jnp.where(fb, cb, ca + cb),
                jnp.where(fb, kb, jnp.minimum(ka, kb)))

    _, cnt_tot, kmin_tot = jax.lax.associative_scan(
        comb, (startf, cnt_s, kmin_s), axis=1)
    nxt = jnp.concatenate(
        [node_s[:, 1:], jnp.full((B2, 1), -1, jnp.int32)], axis=1)
    is_end = (node_s != nxt) & (node_s != _INF)
    ok = is_end & _sat_ok(node_s, cnt_tot, kmin_tot, lens, seq_lens,
                          split_len)
    return _compact_rows(ok, node_s, cap)


_SPARSE_HEAD = 4  # saturated-node columns in the always-pulled head


def _sat_two_tier(out, overflow, counts, cap: int):
    """(head, full): the head carries the first _SPARSE_HEAD node
    columns plus the per-read saturated count, so the host drain pulls
    ~cap/HEAD x less D2H in the common case (a read rarely saturates
    more than 2 nodes) and fetches the full (2B, cap) list only for
    batches where some count exceeds the head. The cap-overflow flag
    rides as one extra row appended to the head, so a batch needs no
    separate scalar pull. Whether this still pays over PCIe is not
    measured yet (ROADMAP.md)."""
    H = min(_SPARSE_HEAD, cap)
    head = jnp.concatenate([out[:, :H], counts[:, None]], axis=1)
    ovf_row = jnp.zeros((1, H + 1), jnp.int32).at[0, 0].set(
        overflow.astype(jnp.int32))
    return jnp.concatenate([head, ovf_row], axis=0), out


def _sparse_sortfill_core(codes, lens, tab_h1, seq_lens, pays,
                          split_len: int, depth: int, cap: int,
                          num_nodes: int, fill: str, node_bits: int,
                          stride: int = 1, cap_c: int = 32):
    node_t = _sortfill_node_slots(codes, lens, tab_h1, pays, split_len,
                                  num_nodes, fill=fill,
                                  node_bits=node_bits, stride=stride)
    B2, R = node_t.shape
    matched = node_t < num_nodes
    node_key = jnp.where(matched, node_t, _INF)
    kidx = jax.lax.broadcasted_iota(jnp.int32, (B2, R), 1) // depth
    kidx_v = jnp.where(matched, kidx, _INF)
    out, overflow, counts = _sparse_sat_tail(
        node_key, kidx_v, lens, seq_lens, split_len, cap,
        kmax=R // depth, cap_c=cap_c)
    return _sat_two_tier(out, overflow, counts, cap)


@partial(jax.jit,
         static_argnames=("split_len", "depth", "cap", "num_nodes",
                          "fill", "node_bits", "stride", "cap_c"))
def _stats_sparse_sortfill(fc, fl, rc, rl, tab_h1, seq_lens, pays,
                           split_len: int, depth: int, cap: int,
                           num_nodes: int, fill: str, node_bits: int,
                           stride: int = 1, cap_c: int = 32):
    """Sparse saturated-node lists via the packed-payload probe: the
    whole per-batch pipeline (stack, hash, sortfill join, row-sort
    stats, saturation, compaction) in ONE dispatch, with no table
    gathers on the match path. Same outputs as the classic sparse
    kernel (node ids come from the payloads, saturation from the shared
    tail), so the COO accumulation downstream is unchanged."""
    codes, lens = _stack_ends(fc, fl, rc, rl)
    return _sparse_sortfill_core(codes, lens, tab_h1, seq_lens, pays,
                                 split_len, depth, cap, num_nodes, fill,
                                 node_bits, stride, cap_c=cap_c)


@partial(jax.jit,
         static_argnames=("T", "split_len", "depth", "cap", "num_nodes",
                          "fill", "node_bits", "stride", "cap_c"))
def _stats_sparse_sortfill_wire(wire, tab_h1, seq_lens, pays, T: int,
                                split_len: int, depth: int, cap: int,
                                num_nodes: int, fill: str,
                                node_bits: int, stride: int = 1,
                                cap_c: int = 32):
    """_stats_sparse_sortfill fed by the compact wire format."""
    codes, lens = _unpack_wire(wire, T)
    return _sparse_sortfill_core(codes, lens, tab_h1, seq_lens, pays,
                                 split_len, depth, cap, num_nodes, fill,
                                 node_bits, stride, cap_c=cap_c)


def _ragged_cross_np(av, ao, bv, bo, na, nb, N, triu=False):
    """Cross-product link keys over ragged per-read node lists.

    (av, ao, na) are the flattened values / row offsets / row counts of
    one side; work is O(actual pairs), not O(B * cap^2). With triu only
    position pairs i <= j survive (ascending same-end pairs, diagonal
    included)."""
    per = (na * nb).astype(np.int64)
    P = int(per.sum())
    if not P:
        return np.zeros(0, np.int64)
    starts = np.zeros(len(per), np.int64)
    np.cumsum(per[:-1], out=starts[1:])
    row = np.repeat(np.arange(len(per)), per)
    local = np.arange(P, dtype=np.int64) - starts[row]
    i = local // nb[row]
    j = local % nb[row]
    keys = av[ao[row] + i] * N + bv[bo[row] + j]
    if triu:
        keys = keys[i <= j]
    return keys


def _sparse_pairs_np(f_nodes: np.ndarray, r_nodes: np.ndarray, N: int):
    """COO link keys for one batch from compacted saturated node lists.

    Mirrors the reference pair loops (PE_Inference.py:174-188): PE pairs
    are the full fwd x rve cross product; same-end pairs are ascending
    (u at-or-before v in the per-read list, diagonal included). The
    expansion is ragged — a typical read saturates 1-2 nodes, so a dense
    (B, cap, cap) product would do ~250x the needed work."""
    fm = f_nodes >= 0
    rm = r_nodes >= 0
    nf = fm.sum(1).astype(np.int64)
    nr = rm.sum(1).astype(np.int64)
    fv = f_nodes[fm].astype(np.int64)
    rv = r_nodes[rm].astype(np.int64)
    fo = np.zeros(len(nf), np.int64)
    np.cumsum(nf[:-1], out=fo[1:])
    ro = np.zeros(len(nr), np.int64)
    np.cumsum(nr[:-1], out=ro[1:])
    pe = _ragged_cross_np(fv, fo, rv, ro, nf, nr, N)
    shorts = [
        _ragged_cross_np(fv, fo, fv, fo, nf, nf, N, triu=True),
        _ragged_cross_np(rv, ro, rv, ro, nr, nr, N, triu=True),
    ]
    return pe, np.concatenate(shorts)


def _merge_coo(key_chunks, count_chunks):
    """Merge per-batch (keys, counts) COO chunks into one sorted unique
    (keys, counts) pair, vectorized (sort + reduceat)."""
    if not key_chunks:
        return (np.zeros(0, np.int64), np.zeros(0, np.int64))
    keys = np.concatenate(key_chunks)
    counts = np.concatenate(count_chunks)
    if keys.size == 0:
        return (keys, counts.astype(np.int64))
    order = np.argsort(keys, kind="stable")
    keys = keys[order]
    counts = counts[order]
    starts = np.flatnonzero(
        np.concatenate([[True], keys[1:] != keys[:-1]]))
    return keys[starts], np.add.reduceat(counts.astype(np.int64), starts)


@jax.jit
def _accumulate(acc_nm, acc_sm, nm, sm):
    return acc_nm + nm, acc_sm + sm


def _stack_ends(fc, fl, rc, rl):
    """Stack fwd+rve reads into one (2B, T) end-batch (padding to a common
    read length): halves kernel dispatches and doubles the sort-join's
    amortization. Split the saturation masks back afterwards."""
    Tf = fc.shape[1]
    Tr = rc.shape[1]
    T = max(Tf, Tr)
    if Tf < T:
        fc = jnp.pad(fc, ((0, 0), (0, T - Tf)), constant_values=255)
    if Tr < T:
        rc = jnp.pad(rc, ((0, 0), (0, T - Tr)), constant_values=255)
    return jnp.concatenate([fc, rc]), jnp.concatenate([fl, rl])


def _pe_batch_sorted(fc, fl, rc, rl, tab, split_len, max_dup, num_nodes,
                     lookup=None):
    """Full batch via the split probe kernels.

    Both read ends are stacked into one (2B, T) end-batch so the hash,
    probe, and stats stages each run once per pair batch. `lookup` is
    (bucket_starts_dev, shift, scan_depth) for the direct-address probe
    (default); None falls back to the per-batch sort-merge join.
    """
    tab_h1, tab_h2, tab_node, seq_lens = tab
    B = fc.shape[0]
    codes, lens = _stack_ends(fc, fl, rc, rl)

    if lookup is not None:
        bstarts, shift, probe_depth = lookup
        q1, h2qi, valid, lo = _hash_lookup_kernel(
            codes, lens, bstarts, tab_h1, split_len=split_len,
            shift=shift, probe_depth=probe_depth)
    else:
        q1, h2qi, valid, lo = _hash_join_kernel(codes, lens, tab_h1,
                                                split_len=split_len)
    K = codes.shape[1] - split_len + 1
    sat = _stats_saturate_kernel(
        q1, h2qi, valid, lo, lens, tab_h1, tab_h2, tab_node,
        seq_lens, split_len=split_len, max_dup=max_dup,
        num_nodes=num_nodes,
        stats_impl=_stats_impl_choice(num_nodes, K, max_dup))
    return _pair_matmuls_jit(sat[:B], sat[B:], num_nodes=num_nodes)


# Largest pair batch whose link counts stay exact in the float32 matmuls
# below: a batch adds at most B to a node_mat cell and 2B to a short_mat
# cell, and float32 holds every integer up to 2^24 exactly.
MAX_EXACT_BATCH = 1 << 23


def _pair_matmuls(f, r, num_nodes: int):
    """Link-count accumulation as matrix products (replaces the
    reference's O(|lefts| x |rights|) Python pair loops,
    PE_Inference.py:174-188).

    f and r are 0/1 float32 masks. Precision.DEFAULT lets the GPU run
    the products in one TF32 (or bf16) pass on the tensor cores; that is
    exact here, since 0 and 1 are exact in every input format, each
    product is 0 or 1, and the float32 accumulator holds the counts
    exactly while a batch has at most MAX_EXACT_BATCH pairs."""
    dims = (((0,), (0,)), ((), ()))
    mm = partial(jax.lax.dot_general, dimension_numbers=dims,
                 precision=jax.lax.Precision.DEFAULT,
                 preferred_element_type=jnp.float32)
    node_mat = mm(f, r)
    same = mm(f, f) + mm(r, r)
    N = num_nodes
    rows = jax.lax.broadcasted_iota(jnp.int32, (N, N), 0)
    cols = jax.lax.broadcasted_iota(jnp.int32, (N, N), 1)
    short_mat = jnp.where(rows <= cols, same, 0.0)
    return node_mat.astype(jnp.int32), short_mat.astype(jnp.int32)


def _stats_from_impl(q1, h2qi, valid, lo, tab_h1, tab_h2, tab_node,
                     max_dup: int, num_nodes: int, stats_impl: str):
    """Dispatch to one of the two (count, min-kindex) accumulators."""
    if stats_impl == "onehot":
        return _dup_scan_stats_onehot_impl(q1, h2qi, valid, lo, tab_h1,
                                           tab_h2, tab_node, max_dup,
                                           num_nodes)
    return _dup_scan_stats_impl(q1, h2qi, valid, lo, tab_h1, tab_h2,
                                tab_node, max_dup, num_nodes)


@partial(jax.jit,
         static_argnames=("split_len", "max_dup", "num_nodes",
                          "stats_impl", "probe", "shift", "probe_depth",
                          "fill", "node_bits", "stride"),
         donate_argnums=(4, 5))
def _pe_batch_fused(fc, fl, rc, rl, acc_nm, acc_sm, tab_h1, tab_h2,
                    tab_node, seq_lens, bucket_starts,
                    split_len: int, max_dup: int,
                    num_nodes: int, stats_impl: str = "scatter",
                    probe: str = "sort", shift: int = 32,
                    probe_depth: int = 1, pays=(), fill: str = "cummin",
                    node_bits: int = 9, stride: int = 1):
    """The whole per-batch pipeline — stack ends, hash, sort-merge join,
    duplicate-scan stats, saturation, pair matmuls, accumulate — as ONE
    jitted computation with donated accumulators: one dispatch per
    batch, and XLA fuses across the stages.

    The accumulators are donated: the device reuses their buffers for
    the outputs, so callers must rebind them to the returned arrays and
    never read the arrays they passed in.
    """
    codes, lens = _stack_ends(fc, fl, rc, rl)
    return _pe_batch_core(codes, lens, acc_nm, acc_sm, tab_h1, tab_h2,
                          tab_node, seq_lens, bucket_starts, split_len,
                          max_dup, num_nodes, stats_impl, probe, shift,
                          probe_depth, pays, fill, node_bits, stride)


def _pe_batch_core(codes, lens, acc_nm, acc_sm, tab_h1, tab_h2,
                   tab_node, seq_lens, bucket_starts, split_len, max_dup,
                   num_nodes, stats_impl, probe, shift, probe_depth,
                   pays, fill, node_bits, stride=1):
    """Probe + stats + saturation + pair matmuls on a stacked (2B, T)
    end-batch (shared by the byte-wire and packed-wire entry points)."""
    if probe == "sortfill":
        node_t = _sortfill_node_slots(codes, lens, tab_h1, pays,
                                      split_len, num_nodes, fill=fill,
                                      node_bits=node_bits, stride=stride)
        depth = pays.shape[1]
        if stats_impl == "scatter":
            cnt, kmin = _slots_scatter_accum(node_t, depth, num_nodes)
        else:
            cnt, kmin = _slots_onehot_accum(node_t, depth, num_nodes)
    else:
        if probe == "lookup":
            q1, h2qi, valid, lo = _hash_lookup_impl(
                codes, lens, bucket_starts, tab_h1, split_len, shift,
                probe_depth)
        else:
            q1, h2qi, valid, lo = _hash_join_impl(codes, lens, tab_h1,
                                                  split_len)
        cnt, kmin = _stats_from_impl(q1, h2qi, valid, lo, tab_h1,
                                     tab_h2, tab_node, max_dup,
                                     num_nodes, stats_impl)
    sat = _saturate(cnt, kmin, lens, seq_lens, split_len)
    B = codes.shape[0] // 2
    nm, sm = _pair_matmuls(sat[:B], sat[B:], num_nodes)
    return acc_nm + nm, acc_sm + sm


# --------------------------------------------------------------------------
# compact wire format
#
# Host-to-device read bytes: this wire format sends 2-bit packed bases +
# u16 lengths
# (one uint8 row per pair: fwd codes | rve codes | 4 length bytes) — a
# ~3.9x reduction at 150 bp. Exactness: windows past a read's length are
# already invalidated by the length test in _device_window_hashes, so
# packed padding bits never match; chunks containing a non-ACGT base
# inside a read (rare IUPAC/lowercase survivors of the N-filter) fall
# back to the byte path, where BAD_CODE invalidation applies — identical
# matrices either way. Whether the transfer bounds the GPU run is not
# measured yet (ROADMAP.md).
# --------------------------------------------------------------------------

def _wire_width(T: int) -> int:
    return 2 * (-(-T // 4)) + 4


def _pack_wire_np(fc, fl, rc, rl, T: int) -> np.ndarray:
    """Host-side wire packing of one chunk -> uint8 [B, _wire_width(T)]."""
    B = fc.shape[0]
    T4 = -(-T // 4)
    out = np.zeros((B, 2 * T4 + 4), dtype=np.uint8)

    def pack(codes, dst):
        c = np.where(codes < 4, codes, 0).astype(np.uint8)
        if c.shape[1] < 4 * T4:
            c = np.pad(c, ((0, 0), (0, 4 * T4 - c.shape[1])))
        dst[:] = (c[:, 0::4] | (c[:, 1::4] << 2) | (c[:, 2::4] << 4)
                  | (c[:, 3::4] << 6))

    pack(fc, out[:, :T4])
    pack(rc, out[:, T4: 2 * T4])
    out[:, -4] = fl & 0xFF
    out[:, -3] = fl >> 8
    out[:, -2] = rl & 0xFF
    out[:, -1] = rl >> 8
    return out


def _unpack_wire(wire, T: int):
    """In-jit inverse of _pack_wire_np -> stacked ((2B, T) codes,
    (2B,) lens), the _stack_ends contract."""
    B = wire.shape[0]
    T4 = -(-T // 4)
    shifts = jnp.asarray([0, 2, 4, 6], jnp.uint8)

    def unpack(packed):
        c = (packed[:, :, None] >> shifts[None, None, :]) & jnp.uint8(3)
        return c.reshape(B, 4 * T4)[:, :T]

    fcod = unpack(wire[:, :T4])
    rcod = unpack(wire[:, T4: 2 * T4])
    fl = (wire[:, -4].astype(jnp.int32)
          | (wire[:, -3].astype(jnp.int32) << 8))
    rl = (wire[:, -2].astype(jnp.int32)
          | (wire[:, -1].astype(jnp.int32) << 8))
    return (jnp.concatenate([fcod, rcod]),
            jnp.concatenate([fl, rl]))


@partial(jax.jit,
         static_argnames=("T", "split_len", "max_dup", "num_nodes",
                          "stats_impl", "probe", "shift", "probe_depth",
                          "fill", "node_bits", "stride"),
         donate_argnums=(1, 2))
def _pe_batch_fused_wire(wire, acc_nm, acc_sm, tab_h1, tab_h2,
                         tab_node, seq_lens, bucket_starts, T: int,
                         split_len: int, max_dup: int,
                         num_nodes: int, stats_impl: str = "scatter",
                         probe: str = "sort", shift: int = 32,
                         probe_depth: int = 1, pays=(),
                         fill: str = "cummin", node_bits: int = 9,
                         stride: int = 1):
    """_pe_batch_fused fed by the compact wire format: unpack on device,
    then the shared core."""
    codes, lens = _unpack_wire(wire, T)
    return _pe_batch_core(codes, lens, acc_nm, acc_sm, tab_h1, tab_h2,
                          tab_node, seq_lens, bucket_starts, split_len,
                          max_dup, num_nodes, stats_impl, probe, shift,
                          probe_depth, pays, fill, node_bits, stride)


def _pe_batch_kernel(fwd_codes, fwd_len, rve_codes, rve_len,
                     tab_h1b, tab_h2, tab_node, seq_lens,
                     split_len: int, max_dup: int, num_nodes: int):
    """Full per-batch link accumulation -> (node_mat, short_mat) int32
    [N, N]. Matrix products replace the reference's pair loops
    (PE_Inference.py:174-188)."""
    f = _probe_and_saturate(fwd_codes, fwd_len, tab_h1b, tab_h2, tab_node,
                            seq_lens, split_len, max_dup, num_nodes)
    r = _probe_and_saturate(rve_codes, rve_len, tab_h1b, tab_h2, tab_node,
                            seq_lens, split_len, max_dup, num_nodes)
    return _pair_matmuls(f, r, num_nodes)


# --------------------------------------------------------------------------
# driver
# --------------------------------------------------------------------------

def _has_bad_in_read(codes: np.ndarray, lens: np.ndarray) -> bool:
    """True when any non-ACGT code sits INSIDE a read (padding past the
    length is exempt) — the wire format can't represent it."""
    cols = np.arange(codes.shape[1], dtype=np.int32)
    return bool(np.any((codes > 3) & (cols[None, :] < lens[:, None])))


def _wire_batches(reads: ReadPairBatch, batch_size: int,
                  force_bytes: bool = False):
    """Batch feed over the compact wire format (see _pack_wire_np).

    Yields ("wire", dev_u8[B, W]) batches, falling back to
    ("bytes", (fc, fl, rc, rl)) for any batch holding an in-read
    non-ACGT code or reads too long for u16 lengths. Packing runs
    per batch — the C++ packer (native.wire_pack_native, check fused
    in) when available, vectorized numpy otherwise — so with JAX async
    dispatch the host packs batch i+1 while the device runs batch i;
    the up-front whole-dataset pack this replaces serialized ~30% of
    e2e wall-clock ahead of the first dispatch."""
    B = reads.num_pairs
    T = max(reads.fwd_codes.shape[1], reads.rve_codes.shape[1])
    wire_ok = T < 65536 and not force_bytes
    native_ok = False
    if wire_ok:
        from vstrains_tpu import native as _native
        lib = _native.get_lib()
        native_ok = lib is not None and hasattr(lib, "wire_pack")
    for s in range(0, B, batch_size):
        e = min(s + batch_size, B)
        pad = batch_size - (e - s)
        fc = reads.fwd_codes[s:e]
        rc = reads.rve_codes[s:e]
        fl = reads.fwd_len[s:e]
        rl = reads.rve_len[s:e]
        if pad:
            # zero-length padding reads contribute nothing
            fc = np.pad(fc, ((0, pad), (0, 0)), constant_values=255)
            rc = np.pad(rc, ((0, pad), (0, 0)), constant_values=255)
            fl = np.pad(fl, (0, pad))
            rl = np.pad(rl, (0, pad))
        if wire_ok:
            if native_ok:
                wire = _native.wire_pack_native(fc, fl, rc, rl, T)
            elif not (_has_bad_in_read(fc, fl)
                      or _has_bad_in_read(rc, rl)):
                wire = _pack_wire_np(fc, fl, rc, rl, T)
            else:
                wire = None
            if wire is not None:
                yield ("wire", jnp.asarray(wire))
                continue
        yield ("bytes", (jnp.asarray(fc), jnp.asarray(fl),
                         jnp.asarray(rc), jnp.asarray(rl)))


def _length_buckets(reads: ReadPairBatch, split_len: int,
                    batch_size: int, multiple: int = 32,
                    min_frac: float = 0.10, min_saving: float = 0.15):
    """Width buckets for mixed-length libraries.

    Reads are padded to the dataset-wide maximum, so one 300bp read in a
    150bp library doubles every window count. Pairs are grouped by
    max(end lengths) rounded up to `multiple`; buckets holding under
    `min_frac` of the pairs merge into the next wider one (each distinct
    width is its own XLA compile, so rare widths are not worth a
    kernel). Returns a list of
    (width, index-array) in descending width order, or None when
    bucketing would save < `min_saving` of the window volume (uniform
    libraries, tiny datasets).

    Safe to reorder: the accumulated matrices are integer sums over
    pairs, invariant under any pair permutation."""
    n = reads.num_pairs
    if n < 4 * batch_size:
        return None
    t_max = max(reads.fwd_codes.shape[1], reads.rve_codes.shape[1])
    w = np.maximum(reads.fwd_len[:n], reads.rve_len[:n])
    w = np.maximum(w, split_len)
    w = np.minimum(-(-w // multiple) * multiple, t_max)
    widths, counts = np.unique(w, return_counts=True)
    if len(widths) == 1:
        return None
    # merge sub-threshold buckets upward (the widest always survives)
    kept = [int(wd) for wd, c in zip(widths, counts)
            if c >= min_frac * n or wd == widths[-1]]
    target = np.empty_like(w)
    for wd in sorted(kept, reverse=True):
        target[w <= wd] = wd
    vol = sum(int((target == wd).sum()) * wd for wd in kept)
    if vol > (1.0 - min_saving) * n * t_max:
        return None
    return [(wd, np.nonzero(target == wd)[0])
            for wd in sorted(kept, reverse=True)]


@dataclass
class PEResult:
    ids: List[str]
    node_mat: np.ndarray    # int64 [N, N]  fwd x rve PE links
    short_mat: np.ndarray   # int64 [N, N]  same-end co-occurrence links
    n_reads: int
    short_reads: int
    used_reads: int


@dataclass
class PESparseResult:
    """COO form of the link matrices (the large-N engine output): keys are
    u * num_nodes + v (int64, sorted unique), counts int64. Semantically
    identical to PEResult's matrices — node_mat[u, v] == pair count."""
    ids: List[str]
    pair_keys: np.ndarray
    pair_counts: np.ndarray
    short_keys: np.ndarray
    short_counts: np.ndarray
    n_reads: int
    short_reads: int
    used_reads: int


def build_table_auto(seqs: Sequence[str], split_len: int,
                     logger: logging.Logger = None,
                     probe_mode: str = "sort") -> KmerTable:
    """The driver's default table construction: long node sequences
    hash via the sequence-parallel halo kernel (sharded over the
    device mesh) and short ones on host; bucket index per probe mode.
    Exposed so the pipeline can build the table on a background thread
    overlapping FASTQ loading (the build is seconds of host time at
    metaSPAdes scale)."""
    logger = logger or _LOG
    sp = None
    sp_cutoff = 8192
    if (seqs and max((len(s) for s in seqs), default=0) >= sp_cutoff
            and jax.device_count() > 1):
        try:
            from vstrains_tpu.parallel.mesh import make_mesh
            sp = (make_mesh(model=1), sp_cutoff)
            logger.info("SP table build over %d device(s) for nodes "
                        ">= %d bp", sp[0].shape["data"], sp_cutoff)
        except Exception as exc:
            logger.debug("SP table build unavailable: %s", exc)
    return build_kmer_table(
        seqs, split_len, sp=sp,
        bucket_index=True if probe_mode == "lookup" else "auto")


# Pairs at or below which the CPU backend keeps the dense engine at any N.
_CPU_DENSE_MAX_PAIRS = 65536
# Nodes above which the CPU backend takes the sparse engine: it has no
# matrix units, so the dense path's B*N^2 pair matmuls dominate there.
_CPU_DENSE_MAX_NODES = 1024


def _dense_budget_rows(num_nodes: int) -> int:
    """Largest batch the dense engine takes: ~1.5 GB of (2B, N+1) int32
    stats planes."""
    return max(512, (1_500_000_000 // (12 * (num_nodes + 1))) // 2)


def _sparse_cutover(num_nodes: int, batch_size: int, num_pairs: int,
                    backend: str) -> bool:
    """Whether stats_mode='auto' takes the sparse COO engine.

    The dense engine's cost above a few thousand nodes is everything N-
    and N^2-shaped around the stats: the (N, N) link accumulators and
    their spill, the N-wide saturate, and the N^2*B pair matmuls. So any
    device cuts over where the dense stats planes outgrow their memory
    budget (N ~ 3.8k at the default batch). The CPU backend also cuts
    over above _CPU_DENSE_MAX_NODES on large libraries. Results are
    bit-identical either way."""
    if batch_size > _dense_budget_rows(num_nodes):
        return True
    return (backend == "cpu" and num_nodes > _CPU_DENSE_MAX_NODES
            and num_pairs > _CPU_DENSE_MAX_PAIRS)


def infer_pe_links(ids: Sequence[str], seqs: Sequence[str],
                   reads: ReadPairBatch, kmer_size: int,
                   batch_size: int = 16384,
                   probe_mode: str = "sort",
                   stats_mode: str = "auto",
                   table: Optional[KmerTable] = None,
                   logger: logging.Logger = None):
    """End-to-end PE-link inference for pre-loaded reads.

    `kmer_size` is the graph k; windows are (k+1)-mers
    (PE_Inference.py:114). probe_mode 'sort' (default) uses the
    sort-merge-join probe; 'lookup' probes via the two-phase
    direct-address bucket index; 'searchsorted' keeps the binary-search
    kernel (kept for cross-checking). All three produce identical
    matrices. Per-batch count matrices accumulate on device, so the host
    loop just streams batches and JAX async dispatch pipelines transfer
    and compute; the int32 device accumulator spills into the int64 host
    accumulator well before it could overflow.

    Every kernel runs on JAX's default device; nothing here moves work
    to another backend.
    """
    logger = logger or _LOG
    split_len = kmer_size + 1
    if batch_size > MAX_EXACT_BATCH:
        raise ValueError(f"batch_size {batch_size} exceeds "
                         f"{MAX_EXACT_BATCH}, the largest batch whose "
                         "float32 link counts stay exact")
    if table is None:
        table = build_table_auto(seqs, split_len, logger,
                                 probe_mode=probe_mode)
    else:
        assert table.split_len == split_len, (
            "prebuilt table k mismatch")
        if probe_mode == "lookup" and table.bucket_starts is None:
            raise ValueError("probe_mode='lookup' needs a table built "
                             "with bucket_index=True")
    N = table.num_nodes
    logger.info("kmer table: %d entries, max_dup=%d, scan_depth=%d, "
                "%d nodes", table.num_entries, table.max_dup,
                table.scan_depth, N)

    # don't pad small datasets up to a huge batch (wasted compute and a
    # needless giant-shape compile)
    if reads.num_pairs and batch_size > reads.num_pairs:
        clamped = 512
        while clamped < reads.num_pairs:
            clamped *= 2
        if clamped < batch_size:
            logger.info("pe batch clamped %d -> %d for %d pairs",
                        batch_size, clamped, reads.num_pairs)
            batch_size = clamped
    sparse = (stats_mode == "sparse"
              or (stats_mode == "auto"
                  and _sparse_cutover(N, batch_size, reads.num_pairs,
                                      jax.default_backend())))

    if reads.num_pairs == 0 or table.num_entries == 0:
        node_mat = np.zeros((N, N), dtype=np.int64)
        short_mat = np.zeros((N, N), dtype=np.int64)
        return PEResult(list(ids), node_mat, short_mat, reads.n_reads,
                        reads.short_reads, reads.used_reads)

    # the exact-integer saturation test needs count*rlen < 2^31, i.e.
    # rlen <= ~46k; PE reads are hundreds of bp, so fail loud rather
    # than overflow silently on absurd input
    max_rl = int(max(reads.fwd_len.max(initial=0),
                     reads.rve_len.max(initial=0)))
    if max_rl > 46340:
        raise ValueError(
            f"read length {max_rl} exceeds the engine's exact-integer "
            "saturation range (~46 kb); this engine targets paired-end "
            "short reads")

    if sparse:
        return _infer_pe_links_sparse(ids, table, reads, batch_size,
                                      probe_mode, logger)

    node_mat = np.zeros((N, N), dtype=np.int64)
    short_mat = np.zeros((N, N), dtype=np.int64)

    lookup = None
    if probe_mode == "lookup" and table.bucket_starts is not None:
        lookup = (jnp.asarray(table.bucket_starts),
                  table.bucket_shift, table.scan_depth)
    if probe_mode == "searchsorted":
        kern = jax.jit(partial(_pe_batch_kernel,
                               split_len=split_len,
                               max_dup=table.max_dup,
                               num_nodes=N))
    # single-dispatch fused path (default): one jit call per batch with
    # donated accumulators (see _pe_batch_fused)
    fused = probe_mode in ("sort", "sortjoin", "sortfill", "lookup")
    if fused:
        T = max(reads.fwd_codes.shape[1], reads.rve_codes.shape[1])
        stats_impl = _stats_impl_choice(N, T - split_len + 1,
                                        table.max_dup)
        probe = probe_mode
        # "sort" auto-upgrades to the gather-free payload-sort probe when
        # the graph fits its packing; the choice is a function of the
        # table alone so every backend's runs stay bit-identical.
        # "sortjoin" forces the classic join (cross-check path). Node ids
        # pack adaptively up to 18 bits.
        node_bits = _sortfill_node_bits(N)
        sortfill_ok = (node_bits is not None
                       and table.max_dup <= _SORTFILL_MAX_DUP)
        if probe == "sort" and sortfill_ok:
            probe = "sortfill"
        elif probe == "sortfill" and not sortfill_ok:
            # an explicit sortfill request must obey the same packing
            # limits as the auto-upgrade: beyond them the payload packer
            # would silently truncate duplicate ranks (max_dup > cap) or
            # crash (node_bits is None)
            logger.warning(
                "probe_mode=sortfill unsupported here (N=%d, "
                "max_dup=%d > %d or id overflow); using the classic "
                "sort join instead", N, table.max_dup,
                _SORTFILL_MAX_DUP)
            probe = "sort"
        elif probe == "sortjoin":
            probe = "sort"
        probe_kw = dict(stats_impl=stats_impl, probe=probe)
        if probe == "sortfill":
            probe_kw["pays"] = _table_device_arrays(
                table, want_pays_bits=node_bits)[("pays", node_bits)]
            probe_kw["node_bits"] = node_bits
            probe_kw["fill"] = os.environ.get(
                "VSTRAINS_SORTFILL_FILL", "cummin")
            probe_kw["stride"] = (
                _sortfill_stride(table.num_entries)
                if probe_kw["fill"] == "cummin" else 1)
        elif probe == "lookup":
            probe_kw.update(shift=table.bucket_shift,
                            probe_depth=table.scan_depth)

    # transfer only the table arrays the chosen path reads: the sortfill
    # probe carries h2/node inside its payloads and the bucket index only
    # serves probe="lookup" — at metaSPAdes scale the unread arrays are
    # hundreds of MB of H2D per call
    empty = jnp.zeros(0, jnp.int32)
    sortfill_fused = fused and probe == "sortfill"
    dev = _table_device_arrays(table)
    if not sortfill_fused and "h2" not in dev:
        dev["h2"] = jnp.asarray(table.h2)
        dev["node"] = jnp.asarray(table.node)
    tab = (dev["h1"],
           empty if sortfill_fused else dev["h2"],
           empty if sortfill_fused else dev["node"],
           dev["seq_lens"])
    if fused and probe == "lookup":
        if "bstarts" not in dev:
            dev["bstarts"] = jnp.asarray(table.bucket_starts)
        bstarts = dev["bstarts"]
    else:
        bstarts = empty

    acc_nm = jnp.zeros((N, N), jnp.int32)
    acc_sm = jnp.zeros((N, N), jnp.int32)
    # a batch adds at most batch_size to any matrix cell; spill the
    # int32 device accumulator to the host int64 one with a wide
    # safety margin
    spill_every = max(1, (2**30) // max(batch_size, 1))
    since_spill = 0
    # mixed-length libraries: feed per-width bucket sub-batches so short
    # reads don't pay the widest read's window count (the stats-impl
    # pick above uses the full width; results are identical either way)
    buckets = (_length_buckets(reads, split_len, batch_size)
               if fused else None)
    if buckets is None:
        parts = [reads]
    else:
        logger.info("length buckets (width, pairs): %s",
                    [(wd, len(ix)) for wd, ix in buckets])
        parts = [ReadPairBatch(
            np.ascontiguousarray(reads.fwd_codes[ix, :wd]),
            reads.fwd_len[ix],
            np.ascontiguousarray(reads.rve_codes[ix, :wd]),
            reads.rve_len[ix], 0, 0, len(ix)) for wd, ix in buckets]

    for p in parts:
        Tp = max(p.fwd_codes.shape[1], p.rve_codes.shape[1])
        for kind, payload in _wire_batches(p, batch_size,
                                           force_bytes=not fused):
            if fused and kind == "wire":
                acc_nm, acc_sm = _pe_batch_fused_wire(
                    payload, acc_nm, acc_sm, *tab, bstarts, T=Tp,
                    split_len=split_len, max_dup=table.max_dup,
                    num_nodes=N, **probe_kw)
            elif fused:
                acc_nm, acc_sm = _pe_batch_fused(
                    *payload, acc_nm, acc_sm, *tab, bstarts,
                    split_len=split_len, max_dup=table.max_dup,
                    num_nodes=N, **probe_kw)
            else:
                if probe_mode == "searchsorted":
                    nm, sm = kern(*payload, *tab)
                else:
                    nm, sm = _pe_batch_sorted(*payload, tab, split_len,
                                              table.max_dup, N,
                                              lookup=lookup)
                acc_nm, acc_sm = _accumulate(acc_nm, acc_sm, nm, sm)
            since_spill += 1
            if since_spill >= spill_every:
                node_mat += np.asarray(acc_nm, dtype=np.int64)
                short_mat += np.asarray(acc_sm, dtype=np.int64)
                acc_nm = jnp.zeros((N, N), jnp.int32)
                acc_sm = jnp.zeros((N, N), jnp.int32)
                since_spill = 0
    node_mat += np.asarray(acc_nm, dtype=np.int64)
    short_mat += np.asarray(acc_sm, dtype=np.int64)

    return PEResult(list(ids), node_mat, short_mat, reads.n_reads,
                    reads.short_reads, reads.used_reads)


def _infer_pe_links_sparse(ids, table: KmerTable, reads: ReadPairBatch,
                           batch_size: int, probe_mode: str,
                           logger: logging.Logger,
                           cap: int = 16,
                           cap_c: int = 32) -> "PESparseResult":
    """Large-N driver: same probe kernels, sparse per-batch stats + host
    COO accumulation. Footprint is independent of N, so metaSPAdes-scale
    graphs keep the full batch size."""
    split_len = table.split_len
    N = table.num_nodes
    lookup = None
    if probe_mode == "lookup" and table.bucket_starts is not None:
        lookup = (jnp.asarray(table.bucket_starts), table.bucket_shift,
                  table.scan_depth)
    depth = table.max_dup
    # same table-only auto-upgrade rule as the dense driver: the packed-
    # payload probe replaces the three [2B, K, depth] table gathers with
    # a (key, iota) sort + two cummins + one contiguous payload-row gather
    node_bits = _sortfill_node_bits(N)
    sortfill = (probe_mode == "sort" and node_bits is not None
                and depth <= _SORTFILL_MAX_DUP)
    pays = None
    dev = _table_device_arrays(
        table, want_pays_bits=node_bits if sortfill else None)
    if sortfill:
        fill = os.environ.get("VSTRAINS_SORTFILL_FILL", "cummin")
        stride = (_sortfill_stride(table.num_entries)
                  if fill == "cummin" else 1)
        pays = dev[("pays", node_bits)]
        logger.info("sparse probe: sortfill (node_bits=%d, h2 check %d "
                    "bits, table stride %d)", node_bits,
                    31 - node_bits, stride)

    # clamp by the sparse path's own footprint: ~8 live (2B, K*depth)
    # int32 planes through sort + scans
    T = max(reads.fwd_codes.shape[1], reads.rve_codes.shape[1])
    K = T - split_len + 1
    row_bytes = max(K * max(depth, 1) * 4 * 8, 1)
    budget = max(512, (1_500_000_000 // row_bytes) // 2)
    if batch_size > budget:
        clamped = max(512, 1 << (budget.bit_length() - 1))
        logger.info("sparse pe batch clamped %d -> %d (K=%d, depth=%d)",
                    batch_size, clamped, K, depth)
        batch_size = clamped
    logger.info("sparse PE stats path: N=%d, cap=%d, depth=%d, batch=%d",
                N, cap, depth, batch_size)

    tab_h1 = dev["h1"]
    seq_lens = dev["seq_lens"]
    if sortfill:
        # the payload probe never reads h2/node (they ride inside pays);
        # skip their H2D transfer — ~130MB/call at metaSPAdes scale
        tab_h2 = tab_node = jnp.zeros(0, jnp.int32)
    else:
        if "h2" not in dev:
            dev["h2"] = jnp.asarray(table.h2)
            dev["node"] = jnp.asarray(table.node)
        tab_h2 = dev["h2"]
        tab_node = dev["node"]

    pe_k, pe_c, st_k, st_c = [], [], [], []
    ovfs = []
    Tr = max(reads.fwd_codes.shape[1], reads.rve_codes.shape[1])
    # Windowed two-phase drain on the main thread. Materializing a
    # result right after its dispatch would sync the stream per batch,
    # so the loop dispatches a window of batches AHEAD, and only when 2
    # windows are in flight does it stop dispatching and pull the oldest
    # window — those pulls overlap the newest window's already-queued
    # device compute. The host-side COO pair expansion runs inline.
    # Device-resident footprint is bounded by 2 windows (~3 MB/batch at
    # the default sizes). The window is not yet tuned on the GPU.
    window = max(1, int(os.environ.get("VSTRAINS_DRAIN_WINDOW", "32")))

    from collections import deque as _deque
    inflight: "_deque" = _deque()

    def _drain_one(item) -> None:
        H = _SPARSE_HEAD
        head, sat_full = item
        hn = np.asarray(head)
        # two-tier pull: the head (first H node columns + count, plus
        # the overflow-flag row the kernel appended) is ~cap/H x
        # smaller than the full list; the full (2B, cap) result
        # transfers only when some read in the batch saturated past
        # the head (rare — see _sat_two_tier)
        ovfs.append(bool(hn[-1, 0]))
        hn = hn[:-1]
        if hn[:, H].max(initial=0) <= H:
            sn = hn[:, :H]
        else:
            sn = np.asarray(sat_full)
        b = sn.shape[0] // 2
        pe, st = _sparse_pairs_np(sn[:b], sn[b:], N)
        for arr, kl, cl in ((pe, pe_k, pe_c), (st, st_k, st_c)):
            u, c = np.unique(arr, return_counts=True)
            kl.append(u)
            cl.append(c)

    def _flush(n: int) -> None:
        for _ in range(n):
            _drain_one(inflight.popleft())

    for kind, payload in _wire_batches(reads, batch_size,
                                       force_bytes=not sortfill):
        if sortfill:
            if kind == "wire":
                head, sat_nodes = _stats_sparse_sortfill_wire(
                    payload, tab_h1, seq_lens, pays, T=Tr,
                    split_len=split_len, depth=int(pays.shape[1]),
                    cap=cap, num_nodes=N, fill=fill,
                    node_bits=node_bits, stride=stride, cap_c=cap_c)
            else:
                head, sat_nodes = _stats_sparse_sortfill(
                    *payload, tab_h1, seq_lens, pays,
                    split_len=split_len, depth=int(pays.shape[1]),
                    cap=cap, num_nodes=N, fill=fill,
                    node_bits=node_bits, stride=stride, cap_c=cap_c)
        else:
            fc, fl, rc, rl = payload
            codes, lens = _stack_ends(fc, fl, rc, rl)
            if lookup is not None:
                bstarts, shift, probe_depth = lookup
                q1, h2qi, valid, lo = _hash_lookup_kernel(
                    codes, lens, bstarts, tab_h1, split_len=split_len,
                    shift=shift, probe_depth=probe_depth)
            else:
                q1, h2qi, valid, lo = _hash_join_kernel(
                    codes, lens, tab_h1, split_len=split_len)
            head, sat_nodes = _stats_sparse_kernel(
                q1, h2qi, valid, lo, lens, tab_h1, tab_h2, tab_node,
                seq_lens, split_len=split_len, depth=depth, cap=cap,
                cap_c=cap_c)
        inflight.append((head, sat_nodes))
        if len(inflight) >= 2 * window:
            _flush(window)
    _flush(len(inflight))

    if any(ovfs):  # host bools — parsed from the pulled heads
        if cap >= 256:
            raise RuntimeError(
                "a read saturated more than 256 nodes; graph too "
                "repetitive for the sparse PE path")
        logger.info("sparse caps %d/%d overflowed; retrying with %d/%d",
                    cap, cap_c, cap * 4, cap_c * 4)
        return _infer_pe_links_sparse(ids, table, reads, batch_size,
                                      probe_mode, logger, cap=cap * 4,
                                      cap_c=cap_c * 4)

    pk, pc = _merge_coo(pe_k, pe_c)
    sk, sc = _merge_coo(st_k, st_c)
    return PESparseResult(list(ids), pk, pc, sk, sc, reads.n_reads,
                          reads.short_reads, reads.used_reads)


# --------------------------------------------------------------------------
# file-format parity (aln/pe_info, aln/st_info)
# --------------------------------------------------------------------------

def write_pe_files(result, pe_path: str, st_path: str) -> None:
    """Write the N^2-line `u:v:count` files
    (parity: PE_Inference.py:190-207). Accepts dense PEResult or COO
    PESparseResult (rows rebuilt on the fly) — identical bytes."""
    ids = result.ids
    n = len(ids)
    if isinstance(result, PESparseResult):
        streams = ((result.pair_keys, result.pair_counts, pe_path),
                   (result.short_keys, result.short_counts, st_path))
        for keys, counts, path in streams:
            with open(path, "w") as fh:
                for i in range(n):
                    row = np.zeros(n, dtype=np.int64)
                    a = np.searchsorted(keys, i * n)
                    b = np.searchsorted(keys, (i + 1) * n)
                    row[(keys[a:b] - i * n).astype(np.int64)] = counts[a:b]
                    fh.write("".join(
                        f"{ids[i]}:{ids[j]}:{row[j]}\n" for j in range(n)))
        return
    # row-wise .tolist() + one join per row: per-element numpy scalar
    # indexing made this the slowest part of the PE stage at N ~ 1000
    # (2*N^2 f-string writes); bytes are unchanged
    with open(pe_path, "w") as f_pe, open(st_path, "w") as f_st:
        for i in range(n):
            u = ids[i]
            nrow = result.node_mat[i].tolist()
            srow = result.short_mat[i].tolist()
            f_pe.write("".join(
                f"{u}:{ids[j]}:{nrow[j]}\n" for j in range(n)))
            f_st.write("".join(
                f"{u}:{ids[j]}:{srow[j]}\n" for j in range(n)))


def write_pe_files_sparse(result, pe_path: str, st_path: str) -> None:
    """Write only the NONZERO `u:v:count` lines of the link matrices.

    The reference format (PE_Inference.py:190-207) emits all N^2 pairs,
    zeros included — hundreds of GB at metaSPAdes scale. Its loader
    (VStrains_IO.py:598-627, ours in process_pe_info) initializes every
    pair to 0 before reading, so the zero lines carry no information
    and the sparse files load to the exact same pe_info/st_info dicts
    (tests/test_pe_files.py). Lines keep the full-format order (row-
    major by node index)."""
    ids = result.ids
    n = len(ids)
    if isinstance(result, PESparseResult):
        streams = ((result.pair_keys, result.pair_counts, pe_path),
                   (result.short_keys, result.short_counts, st_path))
        for keys, counts, path in streams:
            nz = counts != 0
            keys, counts = keys[nz], counts[nz]
            us = (keys // n).astype(np.int64)
            vs = (keys - us * n).astype(np.int64)
            with open(path, "w") as fh:
                fh.write("".join(
                    f"{ids[u]}:{ids[v]}:{c}\n" for u, v, c in
                    zip(us.tolist(), vs.tolist(), counts.tolist())))
        return
    streams = ((result.node_mat, pe_path), (result.short_mat, st_path))
    for mat, path in streams:
        us, vs = np.nonzero(mat)
        cs = mat[us, vs]
        with open(path, "w") as fh:
            fh.write("".join(
                f"{ids[u]}:{ids[v]}:{c}\n" for u, v, c in
                zip(us.tolist(), vs.tolist(), cs.tolist())))


def process_pe_info(node_ids: Sequence[str], pe_info_file: str,
                    st_info_file: str):
    """File-based PE-info loader — full parity with the reference
    (/root/reference/utils/VStrains_IO.py:598-627), for interoperating
    with files produced by either engine. Returns (pe_info, dcpy)."""
    pe_info = {}
    node_ids = list(node_ids)
    for u in node_ids:
        for v in node_ids:
            pe_info[(min(u, v), max(u, v))] = 0
    for path in (pe_info_file, st_info_file):
        with open(path, "r") as fh:
            for line in fh:
                if line == "\n":
                    break
                parts = line[:-1].split(":")[:3]
                if len(parts) < 3:
                    continue
                u, v, mark = parts
                key = (min(u, v), max(u, v))
                if key in pe_info:
                    pe_info[key] += int(mark)
    return pe_info, dict(pe_info)


def _coo_to_pe_info(node_ids: Sequence[str], result: PESparseResult):
    """Symmetric PEInfo stores from COO link arrays: fold (u,v)+(v,u)
    into lexicographic (min,max) id keys, diagonal counted once — the
    same contract as the dense fold below."""
    from vstrains_tpu.core.pe_store import PEInfo

    ids = result.ids
    N = len(ids)
    keys = np.concatenate([result.pair_keys, result.short_keys])
    counts = np.concatenate([result.pair_counts, result.short_counts])
    pe = PEInfo()
    if keys.size:
        u = keys // N
        v = keys % N
        folded = np.minimum(u, v) * N + np.maximum(u, v)
        order = np.argsort(folded, kind="stable")
        folded = folded[order]
        counts = counts[order]
        starts = np.flatnonzero(
            np.concatenate([[True], folded[1:] != folded[:-1]]))
        uniq = folded[starts]
        sums = np.add.reduceat(counts, starts)
        node_set = set(node_ids)
        keep = np.array([vid in node_set for vid in ids], dtype=bool)
        for k, c in zip(uniq.tolist(), sums.tolist()):
            i, j = divmod(k, N)
            if keep[i] and keep[j]:
                uu, vv = ids[i], ids[j]
                pe[(min(uu, vv), max(uu, vv))] = int(c)
    return pe, PEInfo(pe)


def pe_info_sparse_from_result(node_ids: Sequence[str],
                               result):
    """Vectorized sparse construction of the symmetric PE-link store:
    equivalent to pe_info_from_result but O(nonzero pairs) instead of
    O(N^2) Python loops, returning PEInfo stores whose missing pairs read
    as 0 (the reference's dense zero-init contract). Accepts dense
    PEResult or COO PESparseResult. Returns (pe_info, dcpy_pe_info)."""
    from vstrains_tpu.core.pe_store import PEInfo

    if isinstance(result, PESparseResult):
        return _coo_to_pe_info(node_ids, result)

    ids = result.ids
    node_set = set(node_ids)
    keep = np.array([vid in node_set for vid in ids], dtype=bool)
    total = result.node_mat + result.short_mat
    sym = total + total.T
    pe = PEInfo()
    # off-diagonal upper triangle
    iu, ju = np.nonzero(np.triu(sym, k=1))
    for i, j in zip(iu.tolist(), ju.tolist()):
        if keep[i] and keep[j]:
            u, v = ids[i], ids[j]
            pe[(min(u, v), max(u, v))] = int(sym[i, j])
    # diagonal
    for i in np.nonzero(np.diagonal(total))[0].tolist():
        if keep[i]:
            u = ids[i]
            pe[(u, u)] = int(total[i, i])
    return pe, PEInfo(pe)


def pe_info_from_result(node_ids: Sequence[str], result: PEResult):
    """Symmetric pe_info dict keyed by lexicographic (min,max) id pairs,
    summing PE and single-strand counts — same contract as process_pe_info
    (/root/reference/utils/VStrains_IO.py:598-627) minus the file
    round-trip. Returns (pe_info, dcpy_pe_info)."""
    pe_info = {}
    node_ids = list(node_ids)
    for u in node_ids:
        for v in node_ids:
            pe_info[(min(u, v), max(u, v))] = 0
    index = {vid: i for i, vid in enumerate(result.ids)}
    total = result.node_mat + result.short_mat
    for u in node_ids:
        iu = index.get(u)
        if iu is None:
            continue
        for v in node_ids:
            iv = index.get(v)
            if iv is None:
                continue
            key = (min(u, v), max(u, v))
            if u == v:
                pe_info[key] += int(total[iu][iu])
            elif u < v:
                # both orders of the matrix fold into the same key
                pe_info[key] += int(total[iu][iv]) + int(total[iv][iu])
    dcpy = dict(pe_info)
    return pe_info, dcpy
