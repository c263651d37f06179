#!/usr/bin/env python3
"""Cumulative sub-stage profile of the production 50k sparse kernel.

Measures where the kernel's device time goes. Five jitted variants over the SAME device-resident
inputs, each stopping one stage later (tiny reduction output defeats
DCE; deltas between variants attribute the wall):

  hash      window hashes (prefix-sum factorization)
  +join     + the (Q + M/S key, iota) sort, reverse cummin, qpos scatter
  +block    + the (B, K, S) anchor-block gather + compare
  +pays     + the (B, K, D) payload row gather + mask -> node_t
  +tail     + the packed (B2, R) row-sort, segmented scans, saturation,
              compaction (the full production kernel)

Env: PROF_NODES (50000), PROF_BS (16384), PROF_STRIDE (8),
PROF_REPS (16).
"""

import json
import os
import sys
import time
from functools import partial

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax
import jax.numpy as jnp


def main():
    n_nodes = int(os.environ.get("PROF_NODES", 50_000))
    bs = int(os.environ.get("PROF_BS", 16384))
    stride = int(os.environ.get("PROF_STRIDE", 8))
    reps = int(os.environ.get("PROF_REPS", 16))

    from bench import synth_workload
    from vstrains_tpu.core.fastq import _pack
    from vstrains_tpu.ops.pe_infer import (_INF,
                                           _build_sortfill_payloads,
                                           _device_window_hashes,
                                           _sortfill_node_bits,
                                           _sparse_sat_tail, _stack_ends,
                                           build_kmer_table)

    refs, fwd, rve, k = synth_workload(n_nodes=n_nodes, n_pairs=bs,
                                       node_len=200)
    split_len = k + 1
    fc, fl = _pack([s.encode() for s in fwd])
    rc, rl = _pack([s.encode() for s in rve])
    tbl = build_kmer_table(refs, split_len)
    node_bits = _sortfill_node_bits(n_nodes)
    pays_np = _build_sortfill_payloads(tbl, node_bits)
    M = tbl.h1_biased.shape[0]
    D = pays_np.shape[1]
    h2_bits = 31 - node_bits

    codes_np, lens_np = _stack_ends(jnp.asarray(fc), jnp.asarray(fl),
                                    jnp.asarray(rc), jnp.asarray(rl))
    codes = jax.device_put(np.asarray(codes_np))
    lens = jax.device_put(np.asarray(lens_np))
    tab_h1 = jax.device_put(tbl.h1_biased)
    pays = jax.device_put(pays_np)
    seq_lens = jax.device_put(tbl.seq_lens)
    jax.block_until_ready((codes, lens, tab_h1, pays, seq_lens))

    S = stride
    M_S = -(-M // S)

    def stage_hash(codes, lens, tab_h1, pays, seq_lens):
        h1q, h2q, valid = _device_window_hashes(codes, lens, split_len)
        return (h1q.astype(jnp.int32).sum()
                + h2q.astype(jnp.int32).sum()
                + valid.sum().astype(jnp.int32))

    def _join(codes, lens, tab_h1):
        h1q, h2q, valid = _device_window_hashes(codes, lens, split_len)
        B, K = h1q.shape
        q1f = (h1q ^ jnp.uint32(0x80000000)).astype(jnp.int32).ravel()
        Q = q1f.shape[0]
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
            jnp.where(siota < Q, ta, M_S), mode="drop").reshape(B, K)
        return h2q, valid, q1f, blocked, ta_q, B, K

    def stage_join(codes, lens, tab_h1, pays, seq_lens):
        _, _, _, _, ta_q, _, _ = _join(codes, lens, tab_h1)
        return ta_q.sum()

    def _block(codes, lens, tab_h1):
        h2q, valid, q1f, blocked, ta_q, B, K = _join(codes, lens,
                                                     tab_h1)
        h1_blk = jnp.take(blocked, ta_q, axis=0, mode="fill",
                          fill_value=_INF)
        q3 = q1f.reshape(B, K)[:, :, None]
        mm = h1_blk == q3
        sidx = jax.lax.broadcasted_iota(jnp.int32, (B, K, S), 2)
        p = jnp.where(mm, sidx, S).min(axis=2)
        ti_q = jnp.where(p < S, ta_q * S + p, M)
        return h2q, valid, ti_q, B, K

    def stage_block(codes, lens, tab_h1, pays, seq_lens):
        _, _, ti_q, _, _ = _block(codes, lens, tab_h1)
        return ti_q.sum()

    def _payg(codes, lens, tab_h1, pays):
        h2q, valid, ti_q, B, K = _block(codes, lens, tab_h1)
        outp = jnp.take(pays, ti_q, axis=0, mode="fill", fill_value=0)
        h2_mask = jnp.int32((1 << h2_bits) - 1)
        node_mask = jnp.int32((1 << node_bits) - 1)
        h2q_top = (h2q >> jnp.uint32(32 - h2_bits)).astype(jnp.int32)
        m = (valid[:, :, None] & (outp < 0)
             & (((outp >> node_bits) & h2_mask) == h2q_top[:, :, None]))
        node_t = jnp.where(m, outp & node_mask,
                           n_nodes).reshape(B, K * D)
        return node_t

    def stage_pays(codes, lens, tab_h1, pays, seq_lens):
        return _payg(codes, lens, tab_h1, pays).sum()

    def stage_tail(codes, lens, tab_h1, pays, seq_lens):
        node_t = _payg(codes, lens, tab_h1, pays)
        B2, R = node_t.shape
        matched = node_t < n_nodes
        node_key = jnp.where(matched, node_t, _INF)
        kidx = jax.lax.broadcasted_iota(jnp.int32, (B2, R), 1) // D
        kidx_v = jnp.where(matched, kidx, _INF)
        out, overflow, counts = _sparse_sat_tail(
            node_key, kidx_v, lens, seq_lens, split_len, 16,
            kmax=R // D)
        return out.sum() + counts.sum() + overflow.astype(jnp.int32)

    stages = [("hash", stage_hash), ("join", stage_join),
              ("block", stage_block), ("pays", stage_pays),
              ("tail", stage_tail)]
    results = {}
    prev = 0.0
    for name, fn in stages:
        jf = jax.jit(fn)
        t0 = time.time()
        float(jf(codes, lens, tab_h1, pays, seq_lens))
        warm = time.time() - t0
        best = 1e9
        for _ in range(3):
            t0 = time.time()
            for _ in range(reps):
                r = jf(codes, lens, tab_h1, pays, seq_lens)
            float(r)
            best = min(best, (time.time() - t0) / reps)
        results[name] = {"ms": round(best * 1000, 1),
                         "delta_ms": round((best - prev) * 1000, 1),
                         "warm_s": round(warm, 1)}
        prev = best
        print(f"# {name}: {results[name]}", file=sys.stderr)

    out = {"backend": jax.default_backend(), "nodes": n_nodes,
           "bs": bs, "stride": stride, "M": M, "D": D,
           "stages": results}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
