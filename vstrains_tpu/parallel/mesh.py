"""Multi-chip scaling over a jax.sharding.Mesh.

Parallelism axes (the reference is single-threaded Python; every axis here
is new design — SURVEY.md section 2):

  data  (DP): read batches shard across chips; each chip runs the full
        probe+saturate+matmul kernel on its shard; int32 link matrices merge
        with psum. Integer addition is associative+commutative, so any
        sharding is bit-identical to the serial loop.
  model (TP): the k-mer table shards across chips by sorted-hash range;
        each chip probes only its shard, producing partial per-(read, node)
        stats; (count, min-kindex) is a commutative monoid, so psum/pmin
        over the model axis reconstructs exact full-table stats before
        the saturation test.
  seq   (SP): window-hash extraction over long node sequences splits the
        sequence axis with (L-1)-code halo exchange between neighbor shards
        (ppermute between devices) — the genomics analogue of context parallelism.

All collectives ride NVLink between the GPUs of a host, and the host
network across hosts via jax.distributed (same psum path). make_mesh
takes devices in order and assumes no torus: every GPU of a host reaches
every other at the same rate.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from functools import partial
from typing import Optional, Sequence

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

try:  # JAX >= 0.6 moved shard_map to the top level
    from jax import shard_map as _shard_map_mod
    shard_map = _shard_map_mod
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

from vstrains_tpu.core.fastq import ReadPairBatch
from vstrains_tpu.ops.pe_infer import (KmerTable, PEResult, PESparseResult,
                                       _SORTFILL_MAX_DUP, _SPARSE_HEAD,
                                       _build_sortfill_payloads,
                                       _dense_budget_rows,
                                       _dup_scan_stats_impl,
                                       _hash_join_impl,
                                       _merge_coo,
                                       _pair_matmuls_jit,
                                       _saturate,
                                       _slots_scatter_accum,
                                       _sortfill_node_bits,
                                       _sortfill_node_slots,
                                       _sortfill_stride,
                                       _sparse_expand_matches,
                                       _sparse_merge_sat_tail,
                                       _sparse_pairs_np,
                                       _sparse_run_stats_compact,
                                       _sparse_sat_tail, _stack_ends,
                                       _stats_saturate_kernel,
                                       build_kmer_table)

_LOG = logging.getLogger(__name__)

_INT32_MAX = np.int32(2**31 - 1)


def make_mesh(data: int = None, model: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a (data, model) mesh over the available devices."""
    devices = list(devices if devices is not None else jax.devices())
    if data is None:
        data = len(devices) // model
    use = np.array(devices[: data * model]).reshape(data, model)
    return Mesh(use, ("data", "model"))


# --------------------------------------------------------------------------
# table sharding (TP)
# --------------------------------------------------------------------------

@dataclass
class ShardedTable:
    """KmerTable split into `n_shards` contiguous sorted-hash ranges, padded
    to equal length with never-matching sentinels."""
    h1_biased: np.ndarray  # int32 [S, M']
    h2: np.ndarray         # int32 [S, M']
    node: np.ndarray       # int32 [S, M']
    offset: np.ndarray     # int32 [S, M']
    max_dup: int
    num_nodes: int
    split_len: int
    seq_lens: np.ndarray


def shard_table(table: KmerTable, n_shards: int) -> ShardedTable:
    m = table.num_entries
    per = -(-m // n_shards) if m else 1
    h1 = np.full((n_shards, per), _INT32_MAX, dtype=np.int32)
    h2 = np.full((n_shards, per), -1, dtype=np.int32)
    node = np.zeros((n_shards, per), dtype=np.int32)
    off = np.zeros((n_shards, per), dtype=np.int32)
    for s in range(n_shards):
        lo = s * per
        hi = min(lo + per, m)
        if hi > lo:
            h1[s, : hi - lo] = table.h1_biased[lo:hi]
            h2[s, : hi - lo] = table.h2[lo:hi]
            node[s, : hi - lo] = table.node[lo:hi]
            off[s, : hi - lo] = table.offset[lo:hi]
    return ShardedTable(h1, h2, node, off, table.max_dup, table.num_nodes,
                        table.split_len, table.seq_lens)


# --------------------------------------------------------------------------
# DP PE-inference step (sort-merge-join probe, read-sharded)
# --------------------------------------------------------------------------

def make_dp_hash_join_step(mesh: Mesh, split_len: int):
    """Per-shard hash + sort-merge join over the 'data' axis; the table is
    replicated, so per-shard join positions equal the global ones."""

    def local(codes, lens, tab_h1):
        return _hash_join_impl(codes, lens, tab_h1, split_len)

    return jax.jit(shard_map(
        local, mesh=mesh,
        in_specs=(P("data", None), P("data"), P(None)),
        out_specs=(P("data", None), P("data", None), P("data", None),
                   P("data", None)),
        check_vma=False,
    ))


def _pe_batch_sorted_dp(fc, fl, rc, rl, tab, hash_join_step, split_len,
                        max_dup, num_nodes):
    """Data-parallel batch step with the fast probe: per-shard join
    (shard_map), then the row-parallel stats and matmul stages run as the
    same jitted kernels as single-chip — GSPMD partitions them over the
    sharded rows, inserting the final psum for the replicated matrices."""
    tab_h1, tab_h2, tab_node, seq_lens = tab
    B = fc.shape[0]
    codes, lens = _stack_ends(fc, fl, rc, rl)
    q1, h2qi, valid, lo = hash_join_step(codes, lens, tab_h1)
    sat = _stats_saturate_kernel(
        q1, h2qi, valid, lo, lens, tab_h1, tab_h2, tab_node,
        seq_lens, split_len=split_len, max_dup=max_dup,
        num_nodes=num_nodes)
    return _pair_matmuls_jit(sat[:B], sat[B:], num_nodes=num_nodes)


def make_dp_sortfill_step(mesh: Mesh, split_len: int, num_nodes: int,
                          node_bits: int, fill: str = "cummin"):
    """Per-shard sortfill slot extraction over the 'data' axis — the
    production single-chip probe, read-sharded. The join position of a
    query depends only on that query and the (replicated) table, so
    per-shard slots equal the global ones; the stats/saturation/matmul
    stages run as global jitted kernels that GSPMD partitions over the
    sharded rows (same pattern as the classic DP step)."""

    def local(codes, lens, tab_h1, pays):
        return _sortfill_node_slots(codes, lens, tab_h1, pays, split_len,
                                    num_nodes, fill=fill,
                                    node_bits=node_bits)

    return jax.jit(shard_map(
        local, mesh=mesh,
        in_specs=(P("data", None), P("data"), P(None), P(None, None)),
        out_specs=P("data", None),
        check_vma=False,
    ))


def _pe_batch_sortfill_dp(fc, fl, rc, rl, tab_h1, pays, seq_lens,
                          slots_step, split_len, num_nodes):
    """Data-parallel batch step with the sortfill probe: sharded slots,
    then GSPMD-partitioned stats + saturation + matmuls (scatter slot
    accumulation; results identical to the one-hot accumulator by
    test)."""
    B = fc.shape[0]
    codes, lens = _stack_ends(fc, fl, rc, rl)
    node_t = slots_step(codes, lens, tab_h1, pays)
    depth = int(pays.shape[1])
    cnt, kmin = _slots_scatter_jit(node_t, depth=depth,
                                   num_nodes=num_nodes)
    sat = _saturate(cnt, kmin, lens, seq_lens, split_len)
    return _pair_matmuls_jit(sat[:B], sat[B:], num_nodes=num_nodes)


_slots_scatter_jit = partial(
    jax.jit, static_argnames=("depth", "num_nodes"))(_slots_scatter_accum)


# --------------------------------------------------------------------------
# DP x TP PE-inference steps (staged sort-join probe; TP shards the table)
# --------------------------------------------------------------------------

def make_tp_hash_join_step(mesh: Mesh, split_len: int):
    """Hash + per-table-shard sort-merge join on a (data, model) mesh.

    Every model rank hashes its data shard identically (cheap, replicated
    output) and joins against its own sorted table shard; the per-shard
    join positions feed the TP stats step, whose (sum, min) stat monoid
    merges exactly across shards."""

    def local(codes, lens, th1):
        th1 = th1[0]  # (1, M') model shard block
        q1, h2qi, valid, lo = _hash_join_impl(codes, lens, th1, split_len)
        return q1, h2qi, valid, lo[None]

    return jax.jit(shard_map(
        local, mesh=mesh,
        in_specs=(P("data", None), P("data"), P("model", None)),
        out_specs=(P("data", None), P("data", None), P("data", None),
                   P("model", "data", None)),
        check_vma=False,
    ))


def make_tp_stats_step(mesh: Mesh, split_len: int, max_dup: int,
                       num_nodes: int):
    """Per-shard duplicate-scan stats + exact psum/pmin merge over the
    model axis + saturation; output replicated over model."""

    def local(q1, h2qi, valid, lo, lens, th1, th2, tn, seq_lens):
        th1, th2, tn = (a[0] for a in (th1, th2, tn))
        cnt, kmin = _dup_scan_stats_impl(
            q1, h2qi, valid, lo[0], th1, th2, tn, max_dup, num_nodes)
        cnt = jax.lax.psum(cnt, "model")
        kmin = jax.lax.pmin(kmin, "model")
        return _saturate(cnt, kmin, lens, seq_lens, split_len)

    return jax.jit(shard_map(
        local, mesh=mesh,
        in_specs=(P("data", None), P("data", None), P("data", None),
                  P("model", "data", None), P("data"),
                  P("model", None), P("model", None), P("model", None),
                  P(None)),
        out_specs=P("data", None),
        check_vma=False,
    ))


def _pe_batch_tp(fc, fl, rc, rl, stab_args, seq_lens, hash_join_step,
                 stats_step, num_nodes):
    """DPxTP batch step: stacked ends through the staged TP kernels."""
    B = fc.shape[0]
    codes, lens = _stack_ends(fc, fl, rc, rl)
    th1, th2, tn = stab_args
    q1, h2qi, valid, lo = hash_join_step(codes, lens, th1)
    sat = stats_step(q1, h2qi, valid, lo, lens, th1, th2, tn, seq_lens)
    return _pair_matmuls_jit(sat[:B], sat[B:], num_nodes=num_nodes)


def shard_sortfill_payloads(table: KmerTable, n_shards: int,
                            node_bits: int):
    """Per-table-shard sortfill payload matrices, stacked to
    (S, M', D) — each shard's payloads are built from its own slice, so
    duplicate runs straddling a shard boundary simply restart their rank
    chain in the next shard; the (sum, min) stat monoid merges the split
    runs exactly (same argument as the classic TP join). Shards pad with
    the same never-matching sentinels as shard_table; D is forced to the
    GLOBAL duplicate bound so every shard's slot tensor has one shape."""
    from vstrains_tpu.ops.pe_infer import _INF
    m = table.num_entries
    per = -(-m // n_shards) if m else 1
    pays = []
    for s in range(n_shards):
        lo = s * per
        hi = min(lo + per, m)
        h1 = np.full(per, _INF, dtype=np.int32)
        h2 = np.full(per, -1, dtype=np.int32)
        node = np.zeros(per, dtype=np.int32)
        if hi > lo:
            h1[: hi - lo] = table.h1_biased[lo:hi]
            h2[: hi - lo] = table.h2[lo:hi]
            node[: hi - lo] = table.node[lo:hi]
        shim = KmerTable(
            h1_biased=h1, h2=h2, node=node,
            offset=np.zeros(per, np.int32), max_dup=table.max_dup,
            num_nodes=table.num_nodes, split_len=table.split_len,
            seq_lens=table.seq_lens, num_entries=hi - lo)
        pays.append(_build_sortfill_payloads(shim, node_bits))
    return np.stack(pays)


def make_tp_sortfill_step(mesh: Mesh, split_len: int, num_nodes: int,
                          node_bits: int, depth: int,
                          fill: str = "cummin"):
    """DPxTP step with the production sortfill probe: every model rank
    extracts node slots against its own table shard's payloads, local
    (count, min-kindex) partials psum/pmin-merge over the model axis,
    then the shared saturation test — exactly the classic TP contract
    with the probe swapped."""

    def local(codes, lens, th1, pays, seq_lens):
        node_t = _sortfill_node_slots(codes, lens, th1[0], pays[0],
                                      split_len, num_nodes, fill=fill,
                                      node_bits=node_bits)
        cnt, kmin = _slots_scatter_accum(node_t, depth, num_nodes)
        cnt = jax.lax.psum(cnt, "model")
        kmin = jax.lax.pmin(kmin, "model")
        return _saturate(cnt, kmin, lens, seq_lens, split_len)

    return jax.jit(shard_map(
        local, mesh=mesh,
        in_specs=(P("data", None), P("data"), P("model", None),
                  P("model", None, None), P(None)),
        out_specs=P("data", None),
        check_vma=False,
    ))


def _pe_batch_tp_sortfill(fc, fl, rc, rl, th1, pays, seq_lens, step,
                          num_nodes):
    B = fc.shape[0]
    codes, lens = _stack_ends(fc, fl, rc, rl)
    sat = step(codes, lens, th1, pays, seq_lens)
    return _pair_matmuls_jit(sat[:B], sat[B:], num_nodes=num_nodes)


def infer_pe_links_sharded(ids: Sequence[str], seqs: Sequence[str],
                           reads: ReadPairBatch, kmer_size: int,
                           mesh: Mesh = None,
                           batch_size: int = 8192,
                           logger: logging.Logger = None,
                           stats_mode: str = "auto"):
    """Data+tensor-parallel PE-link inference over a device mesh.

    Bit-identical to ops.pe_infer.infer_pe_links (and hence to the serial
    reference accumulation) for any mesh shape — property-tested in
    tests/test_parallel.py.

    Dense/sparse cutover mirrors the single-chip driver: above a few
    thousand nodes everything N^2-shaped (link accumulators, pair
    matmuls) dominates, so the run routes to the sharded sparse engine
    (infer_pe_links_sparse_sharded) and returns a PESparseResult —
    same union-return contract as infer_pe_links.
    """
    logger = logger or _LOG
    if mesh is None:
        mesh = make_mesh()
    n_data = mesh.shape["data"]
    n_model = mesh.shape["model"]
    split_len = kmer_size + 1
    table = build_kmer_table(seqs, split_len)
    N = table.num_nodes
    logger.info("sharded pe: mesh data=%d model=%d, table %d entries",
                n_data, n_model, table.num_entries)

    # the single-chip driver's memory cutover (ops.pe_infer._sparse_cutover)
    if stats_mode == "sparse" or (stats_mode == "auto"
                                  and batch_size > _dense_budget_rows(N)):
        return infer_pe_links_sparse_sharded(
            ids, seqs, reads, kmer_size, mesh=mesh,
            batch_size=batch_size, logger=logger, table=table)

    node_mat = np.zeros((N, N), dtype=np.int64)
    short_mat = np.zeros((N, N), dtype=np.int64)
    if reads.num_pairs == 0 or table.num_entries == 0:
        return PEResult(list(ids), node_mat, short_mat, reads.n_reads,
                        reads.short_reads, reads.used_reads)

    sortfill = False
    if n_model == 1:
        # read-sharded probe, table replicated; same table-only
        # auto-upgrade rule as the single-chip driver, so the mesh path
        # runs the production sortfill kernel when the graph fits it
        node_bits = _sortfill_node_bits(N)
        sortfill = (node_bits is not None
                    and table.max_dup <= _SORTFILL_MAX_DUP)
        if sortfill:
            slots_step = make_dp_sortfill_step(mesh, split_len, N,
                                               node_bits)
            tab_h1_j = jnp.asarray(table.h1_biased)
            pays_j = jnp.asarray(
                _build_sortfill_payloads(table, node_bits))
            seq_lens_dp = jnp.asarray(table.seq_lens)
            logger.info("dp probe: sortfill (node_bits=%d)", node_bits)
        else:
            hash_join_step = make_dp_hash_join_step(mesh, split_len)
            tab_args_dp = (jnp.asarray(table.h1_biased),
                           jnp.asarray(table.h2), jnp.asarray(table.node),
                           jnp.asarray(table.seq_lens))
    else:
        # staged DPxTP: per-shard probe + stat-monoid psum/pmin merge;
        # same sortfill auto-upgrade rule as the single-chip driver
        node_bits = _sortfill_node_bits(N)
        sortfill_tp = (node_bits is not None
                       and table.max_dup <= _SORTFILL_MAX_DUP)
        stab = shard_table(table, n_model)
        if sortfill_tp:
            pays_tp = jnp.asarray(
                shard_sortfill_payloads(table, n_model, node_bits))
            depth_tp = int(pays_tp.shape[2])
            tp_step = make_tp_sortfill_step(mesh, split_len, N,
                                            node_bits, depth_tp)
            th1_tp = jnp.asarray(stab.h1_biased)
            seq_lens_j = jnp.asarray(table.seq_lens)
            logger.info("tp probe: sortfill (node_bits=%d, %d shards)",
                        node_bits, n_model)
        else:
            hash_join_step = make_tp_hash_join_step(mesh, split_len)
            stats_step = make_tp_stats_step(mesh, split_len,
                                            table.max_dup, N)
            stab_args = (jnp.asarray(stab.h1_biased),
                         jnp.asarray(stab.h2), jnp.asarray(stab.node))
            seq_lens_j = jnp.asarray(table.seq_lens)

    # batch size must divide evenly over the data axis
    bs = -(-batch_size // n_data) * n_data
    B = reads.num_pairs
    for start in range(0, B, bs):
        end = min(start + bs, B)
        fc = reads.fwd_codes[start:end]
        rc = reads.rve_codes[start:end]
        fl = reads.fwd_len[start:end]
        rl = reads.rve_len[start:end]
        if end - start < bs:
            pad = bs - (end - start)
            fc = np.pad(fc, ((0, pad), (0, 0)), constant_values=255)
            rc = np.pad(rc, ((0, pad), (0, 0)), constant_values=255)
            fl = np.pad(fl, (0, pad))
            rl = np.pad(rl, (0, pad))
        if sortfill:
            nm, sm = _pe_batch_sortfill_dp(
                jnp.asarray(fc), jnp.asarray(fl), jnp.asarray(rc),
                jnp.asarray(rl), tab_h1_j, pays_j, seq_lens_dp,
                slots_step, split_len, N)
        elif n_model == 1:
            nm, sm = _pe_batch_sorted_dp(
                jnp.asarray(fc), jnp.asarray(fl), jnp.asarray(rc),
                jnp.asarray(rl), tab_args_dp, hash_join_step, split_len,
                table.max_dup, N)
        elif sortfill_tp:
            nm, sm = _pe_batch_tp_sortfill(
                jnp.asarray(fc), jnp.asarray(fl), jnp.asarray(rc),
                jnp.asarray(rl), th1_tp, pays_tp, seq_lens_j, tp_step, N)
        else:
            nm, sm = _pe_batch_tp(
                jnp.asarray(fc), jnp.asarray(fl), jnp.asarray(rc),
                jnp.asarray(rl), stab_args, seq_lens_j, hash_join_step,
                stats_step, N)
        node_mat += np.asarray(nm, dtype=np.int64)
        short_mat += np.asarray(sm, dtype=np.int64)

    return PEResult(list(ids), node_mat, short_mat, reads.n_reads,
                    reads.short_reads, reads.used_reads)


# --------------------------------------------------------------------------
# sharded sparse engine (large-N path)
#
# The regime SURVEY section 2's TP row exists for — N or table size past
# one chip's HBM — is exactly where the reference dies on dense
# node_mat/short_mat (/root/reference/utils/VStrains_PE_Inference.py:139-140).
# These steps shard the SPARSE engine (ops.pe_infer._infer_pe_links_sparse):
# nothing N^2-shaped anywhere, reads shard over 'data', the k-mer table
# and its sortfill payload matrix (the real HBM consumer at metaSPAdes
# scale: ~1 GB at N=50k) shard over 'model'. Per-table-shard
# (count, min-k) partials are a (sum, min) monoid, so an all_gather of
# the compact per-read candidate lists + one segmented (sum, min) merge
# reconstructs exact full-table stats before the saturation test —
# bit-identical to single-chip for any mesh shape (tests/test_parallel.py).
# --------------------------------------------------------------------------


def _sparse_head_rows(out, overflow, counts, H: int):
    """Per-shard two-tier head: first H node columns + per-read count,
    with the overflow flag riding as one appended row (a separate scalar
    output would cost a separate pull per batch — see
    ops.pe_infer._sat_two_tier)."""
    head = jnp.concatenate([out[:, :H], counts[:, None]], axis=1)
    ovf_row = jnp.zeros((1, H + 1), jnp.int32).at[0, 0].set(
        overflow.astype(jnp.int32))
    return jnp.concatenate([head, ovf_row], axis=0)


def make_sparse_dp_step(mesh: Mesh, split_len: int, num_nodes: int,
                        node_bits: int, cap: int, fill: str,
                        stride: int, cap_c: int = 32):
    """Read-sharded sparse sortfill step: each data shard runs the full
    single-chip sparse pipeline (stack, hash, sortfill join, row-sort
    run stats, saturation, compaction) on its rows — per-read outputs
    are row-independent, so per-shard results equal the global ones."""
    H = min(_SPARSE_HEAD, cap)

    def local(fc, fl, rc, rl, tab_h1, pays, seq_lens):
        codes, lens = _stack_ends(fc, fl, rc, rl)
        depth = pays.shape[1]
        node_t = _sortfill_node_slots(codes, lens, tab_h1, pays,
                                      split_len, num_nodes, fill=fill,
                                      node_bits=node_bits, stride=stride)
        B2, R = node_t.shape
        matched = node_t < num_nodes
        node_key = jnp.where(matched, node_t, _INT32_MAX)
        kidx = jax.lax.broadcasted_iota(jnp.int32, (B2, R), 1) // depth
        kidx_v = jnp.where(matched, kidx, _INT32_MAX)
        out, overflow, counts = _sparse_sat_tail(
            node_key, kidx_v, lens, seq_lens, split_len, cap,
            kmax=R // depth, cap_c=cap_c)
        return _sparse_head_rows(out, overflow, counts, H), out

    return jax.jit(shard_map(
        local, mesh=mesh,
        in_specs=(P("data", None), P("data"), P("data", None), P("data"),
                  P(None), P(None, None), P(None)),
        out_specs=(P("data", None), P("data", None)),
        check_vma=False,
    ))


def make_sparse_dp_classic_step(mesh: Mesh, split_len: int,
                                num_nodes: int, depth: int, cap: int,
                                cap_c: int = 32):
    """Read-sharded sparse step with the classic join probe — taken when
    the graph exceeds the sortfill packing (node_bits > 18 or
    max_dup > 16); same contract as make_sparse_dp_step."""
    H = min(_SPARSE_HEAD, cap)

    def local(fc, fl, rc, rl, tab_h1, tab_h2, tab_node, seq_lens):
        codes, lens = _stack_ends(fc, fl, rc, rl)
        q1, h2qi, valid, lo = _hash_join_impl(codes, lens, tab_h1,
                                              split_len)
        node_key, kidx_v = _sparse_expand_matches(
            q1, h2qi, valid, lo, tab_h1, tab_h2, tab_node, depth)
        out, overflow, counts = _sparse_sat_tail(
            node_key, kidx_v, lens, seq_lens, split_len, cap,
            kmax=q1.shape[1], cap_c=cap_c)
        return _sparse_head_rows(out, overflow, counts, H), out

    return jax.jit(shard_map(
        local, mesh=mesh,
        in_specs=(P("data", None), P("data"), P("data", None), P("data"),
                  P(None), P(None), P(None), P(None)),
        out_specs=(P("data", None), P("data", None)),
        check_vma=False,
    ))


def make_sparse_tp_step(mesh: Mesh, split_len: int, num_nodes: int,
                        cap: int, cap_c: int, depth: int,
                        sortfill: bool, node_bits: int = 0,
                        fill: str = "cummin", stride: int = 1):
    """DPxTP sparse step: every model rank probes its own table shard
    (sortfill payloads or classic join), reduces its matches to compact
    per-read (node, count, min-k) candidate lists, all_gathers the
    lists over the model axis, and one segmented (sum, min) merge +
    saturation reconstructs the exact global saturated-node lists —
    the sparse counterpart of the dense TP psum/pmin monoid merge."""
    H = min(_SPARSE_HEAD, cap)

    def local(fc, fl, rc, rl, th1, tshard2, tshard3, seq_lens):
        codes, lens = _stack_ends(fc, fl, rc, rl)
        if sortfill:
            pays = tshard2[0]
            node_t = _sortfill_node_slots(
                codes, lens, th1[0], pays, split_len, num_nodes,
                fill=fill, node_bits=node_bits, stride=stride)
            B2, R = node_t.shape
            matched = node_t < num_nodes
            node_key = jnp.where(matched, node_t, _INT32_MAX)
            kidx = (jax.lax.broadcasted_iota(jnp.int32, (B2, R), 1)
                    // depth)
            kidx_v = jnp.where(matched, kidx, _INT32_MAX)
            kmax = R // depth
        else:
            q1, h2qi, valid, lo = _hash_join_impl(codes, lens, th1[0],
                                                  split_len)
            node_key, kidx_v = _sparse_expand_matches(
                q1, h2qi, valid, lo, th1[0], tshard2[0], tshard3[0],
                depth)
            kmax = q1.shape[1]
        nodes, cnts, kmins, ovf_c = _sparse_run_stats_compact(
            node_key, kidx_v, num_nodes, kmax, cap_c)
        nodes_g = jax.lax.all_gather(nodes, "model", axis=1, tiled=True)
        cnts_g = jax.lax.all_gather(cnts, "model", axis=1, tiled=True)
        kmins_g = jax.lax.all_gather(kmins, "model", axis=1, tiled=True)
        out, ovf_s, counts = _sparse_merge_sat_tail(
            nodes_g, cnts_g, kmins_g, lens, seq_lens, split_len, cap)
        ovf = (jax.lax.psum(ovf_c.astype(jnp.int32), "model") > 0) | ovf_s
        return _sparse_head_rows(out, ovf, counts, H), out

    shard2_spec = (P("model", None, None) if sortfill
                   else P("model", None))
    return jax.jit(shard_map(
        local, mesh=mesh,
        in_specs=(P("data", None), P("data"), P("data", None), P("data"),
                  P("model", None), shard2_spec, P("model", None),
                  P(None)),
        out_specs=(P("data", None), P("data", None)),
        check_vma=False,
    ))


def infer_pe_links_sparse_sharded(ids: Sequence[str],
                                  seqs: Sequence[str],
                                  reads: ReadPairBatch, kmer_size: int,
                                  mesh: Mesh = None,
                                  batch_size: int = 8192,
                                  logger: logging.Logger = None,
                                  cap: int = 16,
                                  cap_c: Optional[int] = None,
                                  table: Optional[KmerTable] = None
                                  ) -> PESparseResult:
    """Multi-chip large-N PE inference: the sparse COO engine sharded
    DP over reads x TP over the k-mer table. Returns the same
    PESparseResult as the single-chip sparse engine, bit-identical for
    any mesh shape (integer (sum, min) merges; tests/test_parallel.py).
    """
    import os

    logger = logger or _LOG
    if mesh is None:
        mesh = make_mesh()
    n_data = mesh.shape["data"]
    n_model = mesh.shape["model"]
    split_len = kmer_size + 1
    if table is None:
        table = build_kmer_table(seqs, split_len)
    N = table.num_nodes
    if reads.num_pairs == 0 or table.num_entries == 0:
        z = np.zeros(0, np.int64)
        return PESparseResult(list(ids), z, z.copy(), z.copy(),
                              z.copy(), reads.n_reads,
                              reads.short_reads, reads.used_reads)

    node_bits = _sortfill_node_bits(N)
    sortfill = (node_bits is not None
                and table.max_dup <= _SORTFILL_MAX_DUP)
    fill = os.environ.get("VSTRAINS_SORTFILL_FILL", "cummin")
    depth = table.max_dup
    if cap_c is None:
        cap_c = max(32, 2 * cap)

    # per-shard footprint clamp (same formula as the single-chip sparse
    # driver, applied to the per-data-shard rows)
    T = max(reads.fwd_codes.shape[1], reads.rve_codes.shape[1])
    K = T - split_len + 1
    row_bytes = max(K * max(depth, 1) * 4 * 8, 1)
    budget = max(512, (1_500_000_000 // row_bytes) // 2)
    if batch_size // n_data > budget:
        clamped = max(512, 1 << (budget.bit_length() - 1)) * n_data
        logger.info("sharded sparse batch clamped %d -> %d", batch_size,
                    clamped)
        batch_size = clamped

    seq_lens_j = jnp.asarray(table.seq_lens)
    if n_model == 1:
        if sortfill:
            stride = (_sortfill_stride(table.num_entries)
                      if fill == "cummin" else 1)
            step = make_sparse_dp_step(mesh, split_len, N, node_bits,
                                       cap, fill, stride, cap_c=cap_c)
            pays = jnp.asarray(_build_sortfill_payloads(table, node_bits))
            depth = int(pays.shape[1])
            tab_args = (jnp.asarray(table.h1_biased), pays, seq_lens_j)
            logger.info("sharded sparse dp: sortfill (node_bits=%d, "
                        "stride=%d, data=%d)", node_bits, stride, n_data)
        else:
            step = make_sparse_dp_classic_step(mesh, split_len, N,
                                               depth, cap, cap_c=cap_c)
            tab_args = (jnp.asarray(table.h1_biased),
                        jnp.asarray(table.h2), jnp.asarray(table.node),
                        seq_lens_j)
            logger.info("sharded sparse dp: classic join (depth=%d, "
                        "data=%d)", depth, n_data)
    else:
        stab = shard_table(table, n_model)
        if sortfill:
            pays_s = jnp.asarray(
                shard_sortfill_payloads(table, n_model, node_bits))
            depth = int(pays_s.shape[2])
            stride = (_sortfill_stride(stab.h1_biased.shape[1])
                      if fill == "cummin" else 1)
            step = make_sparse_tp_step(mesh, split_len, N, cap, cap_c,
                                       depth, True, node_bits=node_bits,
                                       fill=fill, stride=stride)
            # tshard3 is unused by the sortfill branch (node ids ride
            # inside the payloads); ship a 1-column dummy instead of
            # the full [S, M'] node array (~60 MB H2D at 50k)
            tab_args = (jnp.asarray(stab.h1_biased), pays_s,
                        jnp.zeros((n_model, 1), jnp.int32), seq_lens_j)
            logger.info("sharded sparse tp: sortfill (node_bits=%d, "
                        "%d table shards, cap_c=%d)", node_bits,
                        n_model, cap_c)
        else:
            step = make_sparse_tp_step(mesh, split_len, N, cap, cap_c,
                                       depth, False)
            tab_args = (jnp.asarray(stab.h1_biased),
                        jnp.asarray(stab.h2), jnp.asarray(stab.node),
                        seq_lens_j)
            logger.info("sharded sparse tp: classic join (depth=%d, "
                        "%d table shards, cap_c=%d)", depth, n_model,
                        cap_c)

    bs = -(-batch_size // n_data) * n_data
    b_local = bs // n_data
    H = min(_SPARSE_HEAD, cap)
    B = reads.num_pairs
    pe_k, pe_c, st_k, st_c = [], [], [], []
    ovfs = []
    window = max(1, int(os.environ.get("VSTRAINS_DRAIN_WINDOW", "32")))
    from collections import deque as _deque
    inflight: "_deque" = _deque()

    def _drain_one(item) -> None:
        head, sat_full = item
        hn = np.asarray(head).reshape(n_data, 2 * b_local + 1, H + 1)
        ovfs.append(bool(hn[:, -1, 0].any()))
        body = hn[:, :-1, :]
        if body[..., H].max(initial=0) <= H:
            sn = body[..., :H]
        else:
            sn = np.asarray(sat_full).reshape(n_data, 2 * b_local, -1)
        # shard-major row layout: [s0 fwd, s0 rve, s1 fwd, s1 rve, ...]
        fwd = sn[:, :b_local].reshape(n_data * b_local, -1)
        rve = sn[:, b_local:].reshape(n_data * b_local, -1)
        pe, st = _sparse_pairs_np(fwd, rve, N)
        for arr, kl, cl in ((pe, pe_k, pe_c), (st, st_k, st_c)):
            u, c = np.unique(arr, return_counts=True)
            kl.append(u)
            cl.append(c)

    def _flush(n: int) -> None:
        for _ in range(n):
            _drain_one(inflight.popleft())

    for start in range(0, B, bs):
        end = min(start + bs, B)
        fc = reads.fwd_codes[start:end]
        rc = reads.rve_codes[start:end]
        fl = reads.fwd_len[start:end]
        rl = reads.rve_len[start:end]
        if end - start < bs:
            pad = bs - (end - start)
            fc = np.pad(fc, ((0, pad), (0, 0)), constant_values=255)
            rc = np.pad(rc, ((0, pad), (0, 0)), constant_values=255)
            fl = np.pad(fl, (0, pad))
            rl = np.pad(rl, (0, pad))
        inflight.append(step(jnp.asarray(fc), jnp.asarray(fl),
                             jnp.asarray(rc), jnp.asarray(rl),
                             *tab_args))
        if len(inflight) >= 2 * window:
            _flush(window)
    _flush(len(inflight))

    if any(ovfs):
        if cap >= 256:
            raise RuntimeError(
                "a read saturated more than 256 nodes; graph too "
                "repetitive for the sparse PE path")
        logger.info("sharded sparse cap %d/%d overflowed; retrying with "
                    "%d/%d", cap, cap_c, cap * 4, cap_c * 4)
        return infer_pe_links_sparse_sharded(
            ids, seqs, reads, kmer_size, mesh=mesh,
            batch_size=batch_size, logger=logger, cap=cap * 4,
            cap_c=cap_c * 4, table=table)

    pk, pc = _merge_coo(pe_k, pe_c)
    sk, sc = _merge_coo(st_k, st_c)
    return PESparseResult(list(ids), pk, pc, sk, sc, reads.n_reads,
                          reads.short_reads, reads.used_reads)


# --------------------------------------------------------------------------
# sequence-parallel window hashing (SP/CP analogue)
# --------------------------------------------------------------------------

def make_sp_window_hash_step(mesh: Mesh, L: int, block: int):
    """Window hashes of one long sequence, sequence axis sharded over the
    'data' mesh axis with an (L-1)-code halo pulled from the right neighbor
    via ppermute — context-parallelism for k-mer extraction.

    Each shard evaluates its windows with the same prefix-sum hash
    factorization as the single-device kernel (core/seq.
    prefix_hash_weights) over its halo-extended block — the factorization
    is position-independent, so the local result is bit-identical to the
    host computation."""
    from vstrains_tpu.core.seq import prefix_hash_weights

    ext_len = block + L - 1
    weights = prefix_hash_weights(L, ext_len)
    n_shards = mesh.shape["data"]
    perm = [(i, (i - 1) % n_shards) for i in range(n_shards)]  # send left

    def local(codes):  # codes: uint8 [block] (1-D shard over 'data')
        halo_src = codes[: L - 1]
        halo = jax.lax.ppermute(halo_src, "data", perm)
        ext = jnp.concatenate([codes, halo])  # [block + L - 1]
        c = jnp.where(ext < 4, ext, 0).astype(jnp.uint32) + jnp.uint32(1)
        bad = (ext >= 4).astype(jnp.int32)
        hs = []
        for w, s in weights:
            p = jnp.pad(jnp.cumsum(c * jnp.asarray(w)), (1, 0))
            hs.append((p[L:] - p[:block]) * jnp.asarray(s))
        nb = jnp.pad(jnp.cumsum(bad), (1, 0))
        valid = (nb[L:] - nb[:block]) == 0
        return hs[0], hs[1], valid

    return jax.jit(shard_map(
        local, mesh=mesh,
        in_specs=(P("data"),),
        out_specs=(P("data"), P("data"), P("data")),
        check_vma=False,
    ))


def sp_window_hashes(codes: np.ndarray, L: int, mesh: Mesh,
                     bucket: bool = False):
    """Sequence-parallel window hashes of a single long code array; returns
    (h1, h2, valid) for all len(codes)-L+1 windows.

    With bucket=True the padded length rounds up to a power of two so
    repeated calls over different node lengths reuse one compiled step
    (each new shape is a compile)."""
    n_shards = mesh.shape["data"]
    n = codes.shape[0]
    total = n
    if bucket:
        total = 1024
        while total < n:
            total *= 2
    block = -(-total // n_shards)
    padded = np.full(block * n_shards, 255, dtype=np.uint8)
    padded[:n] = codes
    step = make_sp_window_hash_step(mesh, L, block)
    h1, h2, valid = step(jnp.asarray(padded))
    w = n - L + 1
    return (np.asarray(h1)[:w], np.asarray(h2)[:w],
            np.asarray(valid)[:w])
