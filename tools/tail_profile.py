#!/usr/bin/env python3
"""Sub-stage breakdown of the sparse sat tail at N=50k shapes.

Cumulative variants over the same (B2, R) slot input:
  sort      packed row-sort alone
  +scan     + boundary flags and the segment-start scan
  +sat      + saturation test
  +compact  + the (B2, cap) compaction (scatter vs reduction variants)

Env: PROF_NODES, PROF_BATCH, PROF_REPS (as sparse_profile.py).
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
from functools import partial


def main():
    n_nodes = int(os.environ.get("PROF_NODES", 50_000))
    B2 = 2 * int(os.environ.get("PROF_BATCH", 16384))
    reps = int(os.environ.get("PROF_REPS", 8))
    K, depth = 95, 3
    R = K * depth
    cap = 16
    kbits = 7
    print(f"# backend: {jax.default_backend()} B2={B2} R={R}",
          file=sys.stderr)
    from vstrains_tpu.ops.pe_infer import _INF

    rng = np.random.default_rng(0)
    node = rng.integers(0, n_nodes, (B2, R)).astype(np.int32)
    kidx = (np.arange(R)[None, :].repeat(B2, 0) // depth).astype(np.int32)
    miss = rng.random((B2, R)) < 0.55
    v_np = np.where(miss, _INF, (node << kbits) | kidx).astype(np.int32)
    v_dev = jax.device_put(jnp.asarray(v_np))
    lens = jnp.asarray(rng.integers(120, 151, B2).astype(np.int32))
    seq_lens = jnp.asarray(
        rng.integers(150, 250, n_nodes).astype(np.int32))
    kmask = jnp.int32((1 << kbits) - 1)
    split_len = 56

    def head(v):
        v_s = jax.lax.sort(v, dimension=1)
        node_s = jnp.where(v_s == _INF, _INF, v_s >> kbits)
        kidx_s = v_s & kmask
        return v_s, node_s, kidx_s

    def scans(node_s, kidx_s):
        prev = jnp.concatenate(
            [jnp.full((B2, 1), -1, jnp.int32), node_s[:, :-1]], axis=1)
        startf = node_s != prev
        pos = jax.lax.broadcasted_iota(jnp.int32, (B2, R), 1)
        sv = jnp.where(startf, (pos << kbits) | kidx_s, -1)

        def comb(a, b):
            fa, sa = a
            fb, sb = b
            return (fa | fb, jnp.where(fb, sb, jnp.maximum(sa, sb)))

        _, ps = jax.lax.associative_scan(comb, (startf, sv), axis=1)
        return pos, ps >> kbits, ps & kmask

    def sat(node_s, pos, startpos, kmin):
        nxt = jnp.concatenate(
            [node_s[:, 1:], jnp.full((B2, 1), -1, jnp.int32)], axis=1)
        is_end = (node_s != nxt) & (node_s != _INF)
        cnt = pos - startpos + 1
        rl = lens[:, None].astype(jnp.int32)
        N = seq_lens.shape[0]
        ref = jnp.take(seq_lens,
                       jnp.clip(node_s, 0, N - 1)).astype(jnp.int32)
        sat_thresh = jnp.minimum(ref - 1, rl - 1 - kmin) - split_len + 2
        A = jnp.minimum(rl, ref) - split_len + 1
        exp_num = A * (rl - split_len)
        return is_end & ((cnt >= sat_thresh) | (cnt * rl >= exp_num))

    @jax.jit
    def v_sort(v, salt):
        v_s, node_s, kidx_s = head(v + salt - salt)
        return jnp.sum(v_s.astype(jnp.float32))

    @jax.jit
    def v_scan(v, salt):
        v_s, node_s, kidx_s = head(v + salt - salt)
        pos, startpos, kmin = scans(node_s, kidx_s)
        return jnp.sum((startpos + kmin).astype(jnp.float32))

    @jax.jit
    def v_sat(v, salt):
        v_s, node_s, kidx_s = head(v + salt - salt)
        pos, startpos, kmin = scans(node_s, kidx_s)
        ok = sat(node_s, pos, startpos, kmin)
        return jnp.sum(ok.astype(jnp.float32))

    @jax.jit
    def v_full_scatter(v, salt):
        v_s, node_s, kidx_s = head(v + salt - salt)
        pos, startpos, kmin = scans(node_s, kidx_s)
        ok = sat(node_s, pos, startpos, kmin)
        sidx = jnp.cumsum(ok.astype(jnp.int32), axis=1) - 1
        overflow = jnp.any(ok & (sidx >= cap))
        row = jax.lax.broadcasted_iota(jnp.int32, (B2, R), 0)
        tgt = jnp.where(ok & (sidx < cap), sidx, cap)
        out = jnp.full((B2, cap), -1, jnp.int32).at[row, tgt].set(
            node_s, mode="drop")
        return jnp.sum(out.astype(jnp.float32)) + overflow

    @jax.jit
    def v_full_reduce(v, salt):
        v_s, node_s, kidx_s = head(v + salt - salt)
        pos, startpos, kmin = scans(node_s, kidx_s)
        ok = sat(node_s, pos, startpos, kmin)
        sidx = jnp.cumsum(ok.astype(jnp.int32), axis=1) - 1
        overflow = jnp.any(ok & (sidx >= cap))
        cols = []
        for c in range(cap):
            cols.append(jnp.max(
                jnp.where(ok & (sidx == c), node_s, -1), axis=1))
        out = jnp.stack(cols, axis=1)
        return jnp.sum(out.astype(jnp.float32)) + overflow

    def timed(f):
        float(f(v_dev, jnp.int32(0)))
        t0 = time.time()
        for r in range(reps):
            float(f(v_dev, jnp.int32(r)))
        return (time.time() - t0) / reps * 1000

    for name, f in (("sort", v_sort), ("+scan", v_scan),
                    ("+sat", v_sat), ("full/scatter", v_full_scatter),
                    ("full/reduce", v_full_reduce)):
        print(f"{name:14s} {timed(f):8.2f} ms")


if __name__ == "__main__":
    main()
